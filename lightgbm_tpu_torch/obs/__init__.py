"""Observability of the port: TreeSHAP contributions, the memory model
and the counter/event registry."""
