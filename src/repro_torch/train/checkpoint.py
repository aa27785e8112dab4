"""Fault-tolerant checkpoint manager (``repro/train/checkpoint.py``), in
the reference's on-disk format, so a checkpoint written by either package
restores bitwise in the other:

  * ``step_XXXXXXXX/arrays.npz``: every array by its flattened name
    (``params/layers/0/attn/wq``: dict keys and list indices joined by
    ``/``), full shapes; bf16 as its uint16 bits, the dtype name
    (``"bfloat16"``) in ``meta.json``'s ``"dtypes"`` for the view back;
  * ``meta.json``: ``step``, ``time``, ``extra`` (the data iterator's
    state rides here) and ``dtypes``;
  * written to ``.tmp_step_N`` and renamed into place (a preempted save
    never corrupts the latest checkpoint), the newest ``keep`` kept;
  * async save: the host copy happens in :meth:`save`, the file writes on
    a background thread, one save in flight at a time.

The names are the tree's own: the port keeps its layers as a list, the
reference stacks them, so a model checkpoint of one restores into the
other's tree only through ``convert.py``; the format, dtypes and bits are
the same.
"""
from __future__ import annotations

import json
import os
import shutil
import threading
import time
from typing import Any, Dict, Optional

import numpy as np
import torch


def _flatten(tree, prefix=""):
    out = {}
    if isinstance(tree, dict):
        for k, v in tree.items():
            out.update(_flatten(v, f"{prefix}{k}/"))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            out.update(_flatten(v, f"{prefix}{i}/"))
    else:
        out[prefix[:-1]] = tree
    return out


def _unflatten_into(template, flat, prefix=""):
    if isinstance(template, dict):
        return {k: _unflatten_into(v, flat, f"{prefix}{k}/")
                for k, v in template.items()}
    if isinstance(template, (list, tuple)):
        typ = type(template)
        return typ(_unflatten_into(v, flat, f"{prefix}{i}/")
                   for i, v in enumerate(template))
    a = flat[prefix[:-1]]
    return a.to(template.device) if isinstance(template, torch.Tensor) else a


def _to_host(v):
    """(numpy array as stored, dtype name) of a tensor, array or scalar."""
    if isinstance(v, torch.Tensor):
        t = v.detach().cpu()
        if t.dtype == torch.bfloat16:      # numpy has no bf16: its bits
            return t.view(torch.int16).numpy().view(np.uint16), "bfloat16"
        a = t.numpy()
    else:
        a = np.asarray(v)
    return a, str(a.dtype)


def _from_host(a: np.ndarray, want: Optional[str]) -> torch.Tensor:
    a = np.ascontiguousarray(a).reshape(a.shape)    # a 0-d array stays 0-d
    if want == "bfloat16":
        return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(a)


class CheckpointManager:
    def __init__(self, directory: str, *, keep: int = 3,
                 async_save: bool = True):
        self.dir = directory
        self.keep = keep
        self.async_save = async_save
        self._thread: Optional[threading.Thread] = None
        os.makedirs(directory, exist_ok=True)

    # ------------------------------------------------------------------ save
    def save(self, step: int, state: Dict[str, Any],
             extra: Optional[Dict] = None) -> None:
        """state: a tree of tensors (or arrays). Blocks only for the copy
        to the host."""
        host, dtypes = {}, {}
        for k, v in _flatten(state).items():
            host[k], dtypes[k] = _to_host(v)
        self.wait()  # one in-flight save at a time

        def _write():
            tmp = os.path.join(self.dir, f".tmp_step_{step}")
            final = os.path.join(self.dir, f"step_{step:08d}")
            os.makedirs(tmp, exist_ok=True)
            np.savez(os.path.join(tmp, "arrays.npz"), **host)
            meta = {"step": step, "time": time.time(), "extra": extra or {},
                    "dtypes": dtypes}
            with open(os.path.join(tmp, "meta.json"), "w") as f:
                json.dump(meta, f)
            if os.path.exists(final):
                shutil.rmtree(final)
            os.rename(tmp, final)          # atomic publish
            self._gc()

        if self.async_save:
            self._thread = threading.Thread(target=_write, daemon=True)
            self._thread.start()
        else:
            _write()

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None

    def _gc(self) -> None:
        steps = sorted(self.all_steps())
        for s in steps[:-self.keep] if self.keep else []:
            shutil.rmtree(os.path.join(self.dir, f"step_{s:08d}"),
                          ignore_errors=True)

    # --------------------------------------------------------------- restore
    def all_steps(self):
        return sorted(int(name.split("_")[1]) for name in os.listdir(self.dir)
                      if name.startswith("step_"))

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def restore(self, template, step: Optional[int] = None) -> Dict[str, Any]:
        """The checkpoint of ``step`` (default: the latest) in the structure
        of ``template``, as tensors in their stored dtypes, each on its
        template leaf's device."""
        step = step if step is not None else self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoints in {self.dir}")
        path = os.path.join(self.dir, f"step_{step:08d}")
        dtypes = self.meta(step).get("dtypes", {})
        with np.load(os.path.join(path, "arrays.npz")) as z:
            flat = {k: _from_host(z[k], dtypes.get(k)) for k in z.files}
        return _unflatten_into(template, flat)

    def meta(self, step: Optional[int] = None) -> Dict:
        step = step if step is not None else self.latest_step()
        path = os.path.join(self.dir, f"step_{step:08d}", "meta.json")
        with open(path) as f:
            return json.load(f)
