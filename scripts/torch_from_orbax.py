#!/usr/bin/env python3
"""Convert a checkpoint of the JAX package (an orbax directory written by
its ``fit``) into a checkpoint of the PyTorch/CUDA port.

    python scripts/torch_from_orbax.py <orbax ckpt_dir> --out <port ckpt_dir> \\
        [--step N] [--preset pr3] [--config run.json] [--set key=value ...]

The orbax checkpoint stores no config, so the tool is told the run's
config the way both CLIs take it (``--preset``, ``--config``, ``--set``);
the converter refuses a model config the variables do not fit, naming
the keys. It works in three steps:

1. restore the variables with the JAX package's
   ``utils.checkpoint.restore_variables`` (params, batch_stats, the EMA's
   params where the run kept one, and the step; the latest step unless
   ``--step`` names one);
2. convert them with the port's ``utils.convert.state_dict_from_jax``,
   the EMA's tree too (the ViT's per-head attention layout is the
   converter's own);
3. write ``<out>/step_<step>.pt`` with the port's ``utils.checkpoint``:
   the raw parameters and the statistics, and the EMA's parameters in
   its training state, so that the port's ``Predictor``, ``predict``,
   ``evaluate``, ``cli export`` and ``cli serve`` serve what the JAX
   package's ``Predictor`` serves (the EMA where there is one).

The file holds no optimizer state: a port run warm-starts from it
(``train.init_from=<out>``) and does not resume it. Prints one JSON line:
the source, the step, whether an EMA was carried, and the file written.

This tool needs JAX and the JAX package, and runs on the CPU; the port
itself imports neither, and nothing of the port imports this script.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
from typing import List, Optional

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main(argv: Optional[List[str]] = None) -> str:
    """Convert, print the summary line, and return the file written."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("src", help="orbax checkpoint directory of a JAX run")
    ap.add_argument("--out", required=True,
                    help="the port's checkpoint directory to write into")
    ap.add_argument("--step", type=int, default=None,
                    help="the step to convert (default: the latest)")
    ap.add_argument("--preset", default="pr1")
    ap.add_argument("--config", default="", help="JSON config file")
    ap.add_argument("--set", action="append", metavar="KEY=VALUE",
                    help="dotted config override, repeatable")
    args = ap.parse_args(argv)

    if ROOT not in sys.path:
        sys.path.insert(0, ROOT)
    import jax
    import numpy as np

    from rgb_proprioceptive_pose_estimator_tpu.utils.checkpoint import (
        restore_variables,
    )
    from rgb_proprioceptive_pose_estimator_tpu_torch.cli import load_config
    from rgb_proprioceptive_pose_estimator_tpu_torch.utils import checkpoint
    from rgb_proprioceptive_pose_estimator_tpu_torch.utils.convert import (
        port_arrays,
        state_dict_from_jax,
    )

    cfg = load_config(args).override(**{"train.ckpt_dir": args.out})
    restored = restore_variables(args.src, args.step)
    step = restored["step"]
    stats = jax.tree.map(np.asarray, restored["batch_stats"])

    def convert(params):
        return state_dict_from_jax(
            {"params": jax.tree.map(np.asarray, params),
             "batch_stats": stats}, cfg.model)

    state_dict = convert(restored["params"])
    training = {"step": step}
    if restored["ema_params"] is not None:
        ema = convert(restored["ema_params"])
        # the EMA holds the parameters alone: the buffers (the statistics)
        # are the state_dict's
        params = port_arrays({"params": restored["ema_params"]})
        training["ema"] = {k: ema[k] for k in params}
    os.makedirs(args.out, exist_ok=True)
    path = checkpoint.step_path(args.out, step)
    checkpoint.save(path, cfg, state_dict, training)
    print(json.dumps({"src": os.path.abspath(args.src), "step": step,
                      "ema": "ema" in training, "out": path}), flush=True)
    return path


if __name__ == "__main__":
    import jax

    jax.config.update("jax_platforms", "cpu")
    main()
