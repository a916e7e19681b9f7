"""Checkpoints: core files and a step manager with resume.

Counterpart of ``tneq_tpu/utils/checkpoint.py``.  Cores are stored in
safetensors files (``utils/_safetensors.py``, no ``safetensors`` package
needed) under the reference's names: ``core_<name>_real`` /
``core_<name>_imag`` for a complex core, ``core_<name>`` for a real one.

:class:`CheckpointManager` keeps one directory per step,
``step_XXXXXXXX/`` with ``params.safetensors``, ``opt_state.npz`` (the
optimizer state's leaves in flatten order, ``leaf_0`` ...) and
``meta.json`` (the step and the caller's extra record), and the last
``keep`` steps only.

Between the packages: the params cross both ways (same names, dtypes and
axis order).  An ``opt_state`` does not: the port's leaves come in
torch's pytree order (dicts in insertion order, JAX sorts their keys) and
hold a ``torch.Generator``'s state where JAX holds a PRNG key.
"""

from __future__ import annotations

import json
import re
import shutil
from pathlib import Path
from typing import Any, Dict, Mapping, Optional, Tuple

import numpy as np
import torch
from torch.utils._pytree import tree_flatten, tree_unflatten

from ._safetensors import load_file, save_file

__all__ = ["CheckpointManager", "cores_from_tensors", "cores_to_tensors"]


def _numpy(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def cores_to_tensors(params: Mapping[str, Any]) -> Dict[str, np.ndarray]:
    """``{name: core}`` -> the file's tensors (complex split into real and
    imaginary parts)."""
    tensors = {}
    for name, arr in params.items():
        a = _numpy(arr)
        if np.iscomplexobj(a):
            tensors[f"core_{name}_real"] = np.ascontiguousarray(a.real)
            tensors[f"core_{name}_imag"] = np.ascontiguousarray(a.imag)
        else:
            tensors[f"core_{name}"] = np.ascontiguousarray(a)
    return tensors


def cores_from_tensors(tensors: Mapping[str, np.ndarray]) -> Dict[str, np.ndarray]:
    """The file's tensors -> ``{name: ndarray}`` (real and imaginary parts
    joined)."""
    params = {}
    for k, v in tensors.items():
        m = re.match(r"core_(.+)_real$", k)
        if m:
            params[m.group(1)] = v + 1j * tensors[f"core_{m.group(1)}_imag"]
        elif not k.endswith("_imag"):
            params[k[len("core_"):]] = v
    return params


def _leaf_to_numpy(leaf) -> np.ndarray:
    if isinstance(leaf, torch.Generator):
        return leaf.get_state().numpy()
    return _numpy(leaf)


def _leaf_like(saved: np.ndarray, template):
    """A saved leaf in the kind, dtype, shape and device of ``template``."""
    if isinstance(template, torch.Generator):
        gen = torch.Generator(device=template.device)
        gen.set_state(torch.as_tensor(saved, dtype=torch.uint8))
        return gen
    if isinstance(template, torch.Tensor):
        return torch.as_tensor(saved).to(dtype=template.dtype, device=template.device) \
            .reshape(template.shape)
    if isinstance(template, (bool, int, float)):
        return type(template)(saved)
    return saved.astype(np.asarray(template).dtype).reshape(np.shape(template))


class CheckpointManager:
    def __init__(self, directory, keep: int = 3):
        self.directory = Path(directory)
        self.directory.mkdir(parents=True, exist_ok=True)
        self.keep = keep

    def _step_dir(self, step: int) -> Path:
        return self.directory / f"step_{step:08d}"

    def all_steps(self):
        steps = []
        for p in self.directory.glob("step_*"):
            m = re.match(r"step_(\d+)$", p.name)
            if m:
                steps.append(int(m.group(1)))
        return sorted(steps)

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def save(
        self,
        step: int,
        params: Mapping[str, Any],
        opt_state: Any = None,
        extra: Optional[Mapping[str, Any]] = None,
    ) -> Path:
        """Write step ``step`` (params as tensors or arrays), then drop all
        but the last ``keep`` steps."""
        d = self._step_dir(step)
        d.mkdir(parents=True, exist_ok=True)
        save_file(cores_to_tensors(params), d / "params.safetensors")
        if opt_state is not None:
            leaves, _ = tree_flatten(opt_state)
            np.savez(d / "opt_state.npz",
                     **{f"leaf_{i}": _leaf_to_numpy(l) for i, l in enumerate(leaves)})
        meta = {"step": step, "extra": dict(extra or {})}
        (d / "meta.json").write_text(json.dumps(meta, default=str))
        for s in self.all_steps()[: -self.keep] if self.keep else []:
            shutil.rmtree(self._step_dir(s), ignore_errors=True)
        return d

    def load(
        self,
        step: Optional[int] = None,
        opt_state_template: Any = None,
    ) -> Tuple[int, Dict[str, np.ndarray], Any, Dict[str, Any]]:
        """``(step, params, opt_state, extra)`` of ``step`` (default: the
        latest); params as numpy arrays.  ``opt_state_template``: a freshly
        initialised optimizer state whose structure, dtypes and devices
        receive the saved leaves (None skips the restore)."""
        if step is None:
            step = self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoints in {self.directory}")
        d = self._step_dir(step)
        tensors, _ = load_file(d / "params.safetensors")
        params = cores_from_tensors(tensors)

        opt_state = None
        opt_path = d / "opt_state.npz"
        if opt_state_template is not None and opt_path.exists():
            with np.load(opt_path) as data:
                leaves = [data[f"leaf_{i}"] for i in range(len(data.files))]
            template, spec = tree_flatten(opt_state_template)
            if len(leaves) != len(template):
                raise ValueError(
                    f"optimizer state mismatch: checkpoint has {len(leaves)} "
                    f"leaves, template has {len(template)}"
                )
            opt_state = tree_unflatten([_leaf_like(l, t) for l, t in zip(leaves, template)],
                                       spec)

        meta = json.loads((d / "meta.json").read_text())
        return step, params, opt_state, meta.get("extra", {})
