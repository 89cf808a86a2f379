"""Observability of the port: for now the TreeSHAP contributions."""
