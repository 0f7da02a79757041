"""Key-value training logger.

Port of `diffusestylegesture_tpu/train/logger.py` (reference
`main/diffusion/logger.py:36-495`): `logkv` / `logkv_mean` accumulation and
`dumpkvs` to the sinks named by format strings: "stdout" (a table), "json"
(lines), "csv" (appending; a new key rewrites the header once) and
"tensorboard" (`torch.utils.tensorboard`, which raises ImportError where the
tensorboard package is missing); plus the loss-quartile bucketing of the
train loop (`main/train/training_loop.py:350-356`).
"""
from __future__ import annotations

import datetime
import json
import os
import sys
import time
from collections import defaultdict
from typing import Dict, List, Optional, TextIO

import numpy as np


class HumanOutput:
    def __init__(self, fh: TextIO):
        self.fh = fh

    def writekvs(self, kvs: Dict) -> None:
        def fmt(v):
            return f"{v:<8.3g}" if hasattr(v, "__float__") else str(v)

        items = {k: fmt(v) for k, v in sorted(kvs.items())}
        if not items:
            return
        keywidth = max(map(len, items.keys()))
        valwidth = max(map(len, items.values()))
        dashes = "-" * (keywidth + valwidth + 7)
        lines = [dashes]
        for k, v in items.items():
            lines.append(f"| {k}{' ' * (keywidth - len(k))} | {v}{' ' * (valwidth - len(v))} |")
        lines.append(dashes)
        self.fh.write("\n".join(lines) + "\n")
        self.fh.flush()


class JSONOutput:
    def __init__(self, path: str):
        self.path = path

    def writekvs(self, kvs: Dict) -> None:
        with open(self.path, "at") as f:
            f.write(json.dumps({k: float(v) if hasattr(v, "__float__") else v
                                for k, v in kvs.items()}) + "\n")


class CSVOutput:
    """Appends one row a dump; only a new key rewrites the file, once, with the
    wider header. An existing file's header is adopted, so a resumed run
    appends to its own curve."""

    def __init__(self, path: str):
        self.path = path
        self.keys: List[str] = []
        if os.path.exists(path):
            with open(path) as f:
                header = f.readline().strip()
            if header:
                self.keys = header.split(",")

    def writekvs(self, kvs: Dict) -> None:
        extra = sorted(set(kvs) - set(self.keys))
        if extra:
            old_rows: List[Dict] = []
            if self.keys and os.path.exists(self.path):
                with open(self.path) as f:
                    lines = f.read().splitlines()
                old_keys = lines[0].split(",") if lines else []
                old_rows = [dict(zip(old_keys, ln.split(","))) for ln in lines[1:]]
            self.keys.extend(extra)
            with open(self.path, "wt") as f:
                f.write(",".join(self.keys) + "\n")
                for r in old_rows:
                    f.write(",".join(str(r.get(k, "")) for k in self.keys) + "\n")
        with open(self.path, "at") as f:
            f.write(",".join(str(kvs.get(k, "")) for k in self.keys) + "\n")


class TensorBoardOutput:
    """TensorBoard sink (ref `TensorBoardOutputFormat`, `logger.py:150-188`)."""

    def __init__(self, log_dir: str):
        from torch.utils.tensorboard import SummaryWriter

        self.writer = SummaryWriter(log_dir)
        self.step = 0

    def writekvs(self, kvs: Dict) -> None:
        step = int(kvs.get("step", self.step))
        for k, v in kvs.items():
            if hasattr(v, "__float__"):
                self.writer.add_scalar(k, float(v), step)
        self.writer.flush()
        self.step = step + 1


class KVLogger:
    def __init__(self, log_dir: Optional[str] = None, format_strs=("stdout",)):
        self.name2val: Dict[str, float] = defaultdict(float)
        self.name2cnt: Dict[str, int] = defaultdict(int)
        self.outputs = []
        self.log_dir = log_dir
        if log_dir:
            os.makedirs(log_dir, exist_ok=True)
        for fmt in format_strs:
            if fmt == "stdout":
                self.outputs.append(HumanOutput(sys.stdout))
                continue
            if not log_dir:
                raise ValueError(f"the {fmt!r} log sink needs a log_dir")
            if fmt == "json":
                self.outputs.append(JSONOutput(os.path.join(log_dir, "progress.json")))
            elif fmt == "csv":
                self.outputs.append(CSVOutput(os.path.join(log_dir, "progress.csv")))
            elif fmt == "tensorboard":
                self.outputs.append(TensorBoardOutput(log_dir))
            else:
                raise ValueError(f"unknown log format {fmt!r}")
        self._start = time.time()

    def logkv(self, key: str, val) -> None:
        self.name2val[key] = val

    def logkv_mean(self, key: str, val) -> None:
        oldval, cnt = self.name2val[key], self.name2cnt[key]
        self.name2val[key] = oldval * cnt / (cnt + 1) + float(val) / (cnt + 1)
        self.name2cnt[key] = cnt + 1

    def log_loss_dict(self, ts, num_timesteps: int, losses: Dict) -> None:
        """Per key the mean and the per-quartile means of t (ref `training_loop.py:350-356`)."""
        ts = np.asarray(ts)
        for key, values in losses.items():
            values = np.asarray(values)
            self.logkv_mean(key, values.mean())
            for sub_t, sub_loss in zip(ts, values):
                self.logkv_mean(f"{key}_q{int(4 * sub_t / num_timesteps)}", sub_loss)

    def dumpkvs(self) -> Dict:
        out = dict(self.name2val)
        out["_wall_time"] = time.time() - self._start
        for o in self.outputs:
            o.writekvs(out)
        self.name2val.clear()
        self.name2cnt.clear()
        return out

    def log(self, *args) -> None:
        print(datetime.datetime.now().strftime("[%H:%M:%S]"), *args)
