"""Run configuration for the port's command-line entry points (port of
`taxoexpan_tpu/config.py`).

`ConfigParser` loads a JSON config tree, applies CLI overrides declared as
`CustomArg`s (flags, type, config path), makes the timestamped run
directories (`<save_dir>/models/<name>/<ts>` and `<save_dir>/log/...`),
snapshots the merged config into the run directory, and on --resume reads
the `config.json` stored next to the checkpoint. Serving needs only the
reading: `load_run_config` returns that file's tree, or the copy every
checkpoint carries under "config" when the file is absent.
"""
from __future__ import annotations

import json
import logging
import logging.handlers
from datetime import datetime
from functools import reduce
from operator import getitem
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


def setup_logging(log_dir: str | Path | None = None) -> None:
    """Console logging at INFO; with `log_dir`, also a rotating info.log
    there (the reference's logger config)."""
    fmt = "%(asctime)s %(name)s %(levelname)s: %(message)s"
    logging.basicConfig(level=logging.INFO, format=fmt)
    if log_dir is not None:
        Path(log_dir).mkdir(parents=True, exist_ok=True)
        fh = logging.handlers.RotatingFileHandler(
            Path(log_dir) / "info.log", maxBytes=10 * 1024 * 1024,
            backupCount=20, encoding="utf8")
        fh.setLevel(logging.INFO)
        fh.setFormatter(logging.Formatter(fmt))
        logging.getLogger().addHandler(fh)


class CustomArg:
    """One CLI override mapped to a config-tree path."""

    def __init__(self, flags: list[str], type, target):
        self.flags = flags
        self.type = type
        if isinstance(target, str):
            target = tuple(int(t) if t.isdigit() else t
                           for t in target.split(";"))
        self.target = tuple(target)

    @property
    def dest(self) -> str:
        # argparse derives dest from the FIRST long option string
        return self.flags[0].lstrip("-").replace("-", "_")


class ConfigParser:
    def __init__(self, args, options: list[CustomArg] = (),
                 timestamp: bool = True, run_id: str | None = None,
                 primary: bool = True):
        """`args`: the parsed argparse namespace (config, resume, and one
        attribute per option's dest). `run_id`: the run directories' name
        in place of the timestamp (the ranks of a multi-process run agree
        on rank 0's); `primary`: this process writes the config snapshot
        and info.log (rank 0), else it logs to the console only."""
        self.args = args
        self.resume = None
        if getattr(args, "resume", None):
            self.resume = Path(args.resume)
            cfg_fname = self.resume.parent / "config.json"
            if getattr(args, "config", None):
                cfg_fname = Path(args.config)
        else:
            if not getattr(args, "config", None):
                raise ValueError("Configuration file need to be specified. "
                                 "Add '-c config.json', for example.")
            cfg_fname = Path(args.config)
        with open(cfg_fname) as fin:
            self._config = json.load(fin)
        for opt in options:
            value = getattr(args, opt.dest, None)
            if value is not None:
                _set_by_path(self._config, opt.target, value)

        save_root = Path(self._config.get("trainer", {}).get("save_dir",
                                                             "saved/"))
        exper_name = self._config.get("name", "run")
        ts = run_id if run_id is not None else (
            datetime.now().strftime(r"%m%d_%H%M%S") if timestamp else "")
        self._save_dir = save_root / "models" / exper_name / ts
        self._log_dir = save_root / "log" / exper_name / ts
        self._save_dir.mkdir(parents=True, exist_ok=True)
        self._log_dir.mkdir(parents=True, exist_ok=True)
        if primary:
            with open(self._save_dir / "config.json", "w") as fout:
                json.dump(self._config, fout, indent=4)
        setup_logging(self._log_dir if primary else None)

    def __getitem__(self, name):
        return self._config[name]

    def get(self, name, default=None):
        return self._config.get(name, default)

    def __contains__(self, name):
        return name in self._config

    @property
    def config(self) -> dict:
        return self._config

    @property
    def save_dir(self) -> Path:
        return self._save_dir

    @property
    def log_dir(self) -> Path:
        return self._log_dir


def _set_by_path(tree, keys, value):
    reduce(getitem, keys[:-1], tree)[keys[-1]] = value
