"""Run configuration for the port's command-line entry points.

The JAX package's ConfigParser reads the `config.json` stored next to a
checkpoint on --resume (and makes run directories for training). Serving
needs only the reading: `load_run_config` returns that file's tree, or the
copy every checkpoint carries under "config" when the file is absent.
"""
from __future__ import annotations

import json
import logging
from pathlib import Path


def load_run_config(resume: str | Path, checkpoint_state: dict) -> dict:
    cfg_file = Path(resume).parent / "config.json"
    if cfg_file.exists():
        with open(cfg_file) as fin:
            return json.load(fin)
    if checkpoint_state.get("config"):
        return dict(checkpoint_state["config"])
    raise FileNotFoundError(f"no {cfg_file} and no config inside the "
                            f"checkpoint {resume}")


def setup_logging() -> None:
    logging.basicConfig(level=logging.INFO,
                        format="%(asctime)s %(name)s %(levelname)s: "
                               "%(message)s")
