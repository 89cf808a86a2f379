"""Command-line application (``lightgbm_tpu/cli.py``, the reference's
``src/application/application.cpp`` + ``src/main.cpp``).

``python -m lightgbm_tpu_torch.cli config=train.conf [key=value ...]``
(or the ``lightgbm-tpu-torch`` script): ``key=value`` arguments merged
over a config file (the command line wins), then the task: ``train``,
``predict``, ``convert_model`` or ``dump_model``.  Data comes from text
files with ``.weight``/``.query`` side files, models are the reference's
text format.  Every task runs on the card unless ``device=cpu`` is given;
without a card it raises.

``task=predict`` predicts through ``Booster.predict`` (the traversal and
margin kernels on the card), where the JAX package's CLI takes its host
C++ predictor whenever that library builds: an entry point does not move
to the CPU unless asked (README "Parity notes").
"""
from __future__ import annotations

import json
import sys
from typing import Dict, List, Optional

import numpy as np

from .basic import Booster, Dataset
from .config import (Config, canonicalize_params, config_from_params,
                     parse_config_file, resolve_device)
from .engine import train as train_fn
from .utils import log


def parse_cli(argv: List[str]) -> Dict[str, str]:
    """``key=value`` arguments, then the config file's keys that the
    arguments do not give (application.cpp:48-104)."""
    params: Dict[str, str] = {}
    for arg in argv:
        if "=" not in arg:
            log.warning("Unknown CLI argument %s (expected key=value)", arg)
            continue
        k, v = arg.split("=", 1)
        params[k.strip()] = v.strip()
    if "config" in params or "config_file" in params:
        path = params.pop("config", None) or params.pop("config_file")
        for k, v in parse_config_file(path).items():
            params.setdefault(k, v)
    return params


def run_train(cfg: Config, params: Dict[str, str]) -> None:
    """Train on ``data``, evaluate ``valid_data`` (and the training data
    with ``is_training_metric``) every ``output_freq`` iterations, and
    save to ``output_model``; ``snapshot_resume=true`` continues a killed
    run from its newest valid snapshot (the supervisor's relaunch)."""
    if not cfg.data:
        log.fatal("No training data specified (data=...)")
    dtrain = Dataset(cfg.data, params=params)
    valid_sets, valid_names = [], []
    for i, vpath in enumerate(cfg.valid_data):
        valid_sets.append(dtrain.create_valid(vpath))
        valid_names.append(f"valid_{i + 1}")
    if cfg.is_training_metric:
        valid_sets = [dtrain] + valid_sets
        valid_names = ["training"] + valid_names
    booster = train_fn(dict(params), dtrain,
                       num_boost_round=cfg.num_iterations,
                       valid_sets=valid_sets, valid_names=valid_names,
                       early_stopping_rounds=cfg.early_stopping_round or None,
                       verbose_eval=(cfg.output_freq if cfg.verbose >= 1
                                     else False),
                       resume=cfg.snapshot_resume or None)
    booster.save_model(cfg.output_model)
    log.info("Finished training; model saved to %s", cfg.output_model)


def run_predict(cfg: Config, params: Dict[str, str]) -> None:
    """Predict the rows of ``data`` (label column first, as the training
    files) with ``input_model`` into ``output_result``, one row a line,
    ``%.18g``: scores, raw scores (``is_predict_raw_score``) or leaf
    indices (``is_predict_leaf_index``)."""
    if not cfg.data:
        log.fatal("No prediction data specified (data=...)")
    if not cfg.input_model:
        log.fatal("No model specified (input_model=...)")
    booster = Booster(model_file=cfg.input_model, params=params)
    preds = np.asarray(booster.predict(
        cfg.data, num_iteration=cfg.num_iteration_predict,
        raw_score=cfg.is_predict_raw_score,
        pred_leaf=cfg.is_predict_leaf_index,
        pred_early_stop=cfg.pred_early_stop))
    out = preds.reshape(preds.shape[0], -1)
    np.savetxt(cfg.output_result, out, delimiter="\t", fmt="%.18g")
    log.info("Finished prediction; results saved to %s", cfg.output_result)


def model_to_cpp(booster: Booster) -> str:
    """The model as dependency-free C++ if-else code (gbdt.cpp
    ModelToIfElse; ``lightgbm_tpu/cli.py:99``, the same text byte for
    byte) with the NumericalDecision/CategoricalDecision semantics of
    tree.h:231-313: the three missing modes, default-left routing,
    categorical bitsets, multiclass trees interleaved.  It exports

        extern "C" void PredictRawAll(const double* fval, double* out);
        double PredictRaw(const double* fval);      // num_class == 1 only
    """
    trees = booster.inner.models
    k = max(booster.inner.num_class, 1)
    lines = ["#include <cmath>", "",
             "// categorical split bitsets (tree.h cat_threshold)"]
    for ti, t in enumerate(trees):
        for node in range(t.num_leaves - 1):
            if t.is_categorical(node):
                bits = ", ".join(f"{int(b)}u" for b in t.cat_bitset(node))
                lines.append(f"static const unsigned int kCat_{ti}_{node}"
                             f"[] = {{{bits}}};")
    lines += [
        "",
        "// CategoricalDecision (tree.h:268-283)",
        "static bool InBitset(const unsigned int* bits, int n, double fval,",
        "                     bool nan_is_missing) {",
        "  if (std::isnan(fval)) {",
        "    if (nan_is_missing) return false;",
        "    fval = 0.0;",
        "  }",
        "  const int v = static_cast<int>(fval);",
        "  if (v < 0) return false;",
        "  const int i1 = v / 32, i2 = v % 32;",
        "  return i1 < n && ((bits[i1] >> i2) & 1u);",
        "}",
        "",
        'extern "C" void PredictRawAll(const double* fval, double* out) {',
        f"  for (int c = 0; c < {k}; ++c) out[c] = 0.0;",
    ]
    for ti, t in enumerate(trees):
        cls = ti % k
        lines.append(f"  // tree {ti} (class {cls})")
        if t.num_leaves <= 1:
            lines.append(f"  out[{cls}] += {t.leaf_value[0]:.17g};")
            continue
        # an explicit stack: leaf-wise trees can be deeper than Python's
        # recursion limit
        stack = [("node", 0, 1)]
        while stack:
            kind, item, indent = stack.pop()
            if kind == "text":
                lines.append(item)
                continue
            node = item
            pad = "  " * indent
            if node < 0:
                lines.append(f"{pad}out[{cls}] += "
                             f"{t.leaf_value[~node]:.17g};")
                continue
            f = int(t.split_feature[node])
            if t.is_categorical(node):
                nbits = len(t.cat_bitset(node))
                nan_missing = "true" if t.missing_type(node) == 2 else "false"
                cond = (f"InBitset(kCat_{ti}_{node}, {nbits}, fval[{f}], "
                        f"{nan_missing})")
            else:
                # NumericalDecision (tree.h:231-266): NaN maps to 0.0
                # unless missing_type is NaN; a zero-range or NaN missing
                # value routes by default_left; otherwise v <= threshold
                thr = float(t.threshold[node])
                mt = t.missing_type(node)
                dl = "true" if t.default_left(node) else "false"
                v = f"(std::isnan(fval[{f}]) ? 0.0 : fval[{f}])"
                if mt == 2:
                    cond = (f"(std::isnan(fval[{f}]) ? {dl} : "
                            f"(fval[{f}] <= {thr:.17g}))")
                elif mt == 1:
                    cond = (f"(std::fabs({v}) <= 1e-20 ? {dl} : "
                            f"({v} <= {thr:.17g}))")
                else:
                    cond = f"{v} <= {thr:.17g}"
            lines.append(f"{pad}if ({cond}) {{")
            stack.append(("text", f"{pad}}}", 0))
            stack.append(("node", int(t.right_child[node]), indent + 1))
            stack.append(("text", f"{pad}}} else {{", 0))
            stack.append(("node", int(t.left_child[node]), indent + 1))
    lines.append("}")
    if k == 1:
        lines += ["",
                  'extern "C" double PredictRaw(const double* fval) {',
                  "  double out = 0.0;",
                  "  PredictRawAll(fval, &out);",
                  "  return out;",
                  "}"]
    return "\n".join(lines) + "\n"


def run_convert_model(cfg: Config, params: Dict[str, str]) -> None:
    """``task=convert_model``: ``input_model`` as C++ into
    ``convert_model`` (:func:`model_to_cpp`)."""
    booster = Booster(model_file=cfg.input_model, params=params)
    with open(cfg.convert_model, "w") as f:
        f.write(model_to_cpp(booster))
    log.info("Model converted to %s", cfg.convert_model)


def run_dump_model(cfg: Config, params: Dict[str, str]) -> None:
    """``task=dump_model``: the model as JSON (``Booster.dump_model``),
    the surface a file-transport binding (the R package) reads.  The
    output is ``convert_model`` when it is given, under any alias, else
    ``<input_model>.json``."""
    if not cfg.input_model:
        log.fatal("No model specified (input_model=...)")
    given = "convert_model" in canonicalize_params(params)
    out_path = cfg.convert_model if given else cfg.input_model + ".json"
    booster = Booster(model_file=cfg.input_model, params=params)
    with open(out_path, "w") as f:
        json.dump(booster.dump_model(), f)
    log.info("Model dumped to %s", out_path)


TASKS = {"train": run_train, "predict": run_predict,
         "prediction": run_predict, "test": run_predict,
         "convert_model": run_convert_model, "dump_model": run_dump_model}


def main(argv: Optional[List[str]] = None) -> int:
    argv = argv if argv is not None else sys.argv[1:]
    params = parse_cli(argv)
    cfg = config_from_params(params)
    log.set_verbosity(cfg.verbose)
    if cfg.task not in TASKS:
        log.fatal("Unknown task %s", cfg.task)
    resolve_device(cfg.device)
    if cfg.num_machines > 1:
        # the process group comes up before any device work, as the
        # reference CLI's network does (application.cpp:190-224)
        from .parallel.mesh import init_distributed_from_config
        init_distributed_from_config(cfg)
    TASKS[cfg.task](cfg, params)
    return 0


if __name__ == "__main__":
    sys.exit(main())
