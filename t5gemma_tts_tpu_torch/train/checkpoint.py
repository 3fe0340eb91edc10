"""Checkpoint and resume: the port's bundles, in the JAX trainer's layout.

Counterpart of ``t5gemma_tts_tpu/train/checkpoint.py``: ``<exp_dir>/bundle``
is saved with the previous one rotated to ``bundle_prev``, ``best_bundle``
tracks the best validation loss, ``bundle_step{N}`` snapshots on a fixed
cadence, ``progress.json`` records step / epoch / best score and
``config.json`` the model configuration. A bundle holds one file,
``state.pt``: every tensor of the train state under its path
(``torch.save``; read back with ``weights_only=True``) and the data
loader's position (``loader``). :func:`read_params` reads only the
``['params']`` tensors of one, memory-mapped, for the loaders and the
export. An orbax bundle written by the JAX trainer has no ``state.pt`` and
is refused: the port never imports ``jax``, and the JAX package's own
export writes the directory the port loads.

Over a mesh (``mesh`` and the state's ``specs``, ``parallel.state_specs``)
every rank joins in gathering each leaf whole, one leaf at a time, and rank
0 writes the same ``state.pt`` one process writes; all ranks then meet at a
barrier. A bundle restores at any world size and any ``(dp, tp)``: each
rank reads the whole file (memory-mapped) and keeps its own block of each
leaf.
"""

from __future__ import annotations

import dataclasses
import json
import logging
import os
import shutil
from typing import Any, Dict, Optional, Tuple

import torch

from ..utils.tree import (from_paths, keystr, leaves_with_path, parse_keystr,
                          tree_map_with_path)

log = logging.getLogger(__name__)

BUNDLE = "bundle"
BUNDLE_PREV = "bundle_prev"
BEST_BUNDLE = "best_bundle"
PROGRESS = "progress.json"
STATE_FILE = "state.pt"
ORBAX_REFUSAL = (
    "holds no {state}: an orbax bundle of the JAX trainer, which the port "
    "does not read (it never imports jax). Export it with the JAX package, "
    "`python -m t5gemma_tts_tpu.export.hf_export --bundle <exp_dir> --out "
    "<dir>`, and load that directory")


def save_bundle(exp_dir: str, state: Any, progress: Dict[str, Any],
                name: str = BUNDLE, rotate: bool = True,
                loader: Optional[Dict[str, Any]] = None, mesh=None,
                specs: Any = None) -> str:
    """Write ``state`` (a tree of tensors) and ``loader`` (tensors,
    numbers, lists) to ``<exp_dir>/<name>/state.pt`` and ``progress`` to
    ``progress.json``. ``mesh``: ``state`` holds this rank's blocks, laid
    out as ``specs``; collective."""
    path = os.path.join(exp_dir, name)
    if mesh is not None:
        from ..parallel import mesh as mesh_mod

        leaves = {}
        for (p, t), (_, spec) in zip(leaves_with_path(state),
                                     leaves_with_path(specs)):
            whole = mesh_mod.gather_leaf(t.detach(), spec, mesh)
            if mesh.lead:
                leaves[keystr(p)] = whole.cpu()
            del whole
        if mesh.lead:
            _write(exp_dir, path, name, rotate, leaves, loader, progress)
        mesh_mod.barrier(mesh)
        return path
    leaves = {keystr(p): t.detach().cpu() for p, t in leaves_with_path(state)}
    _write(exp_dir, path, name, rotate, leaves, loader, progress)
    return path


def _write(exp_dir, path, name, rotate, leaves, loader, progress) -> None:
    os.makedirs(exp_dir, exist_ok=True)
    if rotate and os.path.exists(path):
        prev = os.path.join(exp_dir, BUNDLE_PREV)
        if os.path.exists(prev):
            shutil.rmtree(prev)
        os.replace(path, prev)
    elif os.path.exists(path):
        shutil.rmtree(path)
    os.makedirs(path)
    torch.save({"state": leaves, "loader": loader},
               os.path.join(path, STATE_FILE))
    with open(os.path.join(exp_dir, PROGRESS), "w") as f:
        json.dump(progress, f, indent=2)


def _read_bundle(path: str, mmap: bool = False) -> Dict[str, Any]:
    """The contents of one bundle directory (``state`` and ``loader``)."""
    return torch.load(_state_file(path), map_location="cpu",
                      weights_only=True, mmap=mmap)


def _state_file(path: str) -> str:
    fn = os.path.join(path, STATE_FILE)
    if not os.path.isfile(fn):
        raise NotImplementedError(
            f"{path} " + ORBAX_REFUSAL.format(state=STATE_FILE))
    return fn


def read_params(path: str) -> Any:
    """The ``['params']`` subtree of the bundle directory ``path`` as a
    nested dict of CPU tensors. The file is memory-mapped and nothing
    else of it (the optimizer state, the loader) is read into memory."""
    saved = torch.load(_state_file(path), map_location="cpu",
                       weights_only=True, mmap=True)
    pairs = [(p[1:], t) for p, t in ((parse_keystr(k), t)
                                     for k, t in saved["state"].items())
             if p[0] == "params"]
    if not pairs:
        raise ValueError(f"{path}: the bundle holds no ['params']")
    return from_paths(pairs)


def restore_bundle(exp_dir: str, template: Any, name: Optional[str] = None,
                   mesh=None, specs: Any = None
                   ) -> Tuple[Any, Dict[str, Any], Optional[Dict[str, Any]]]:
    """The newest usable bundle (``bundle``, else ``bundle_prev``) laid out
    as ``template``, each tensor on its template leaf's device -> (state,
    progress, loader). ``mesh``: ``template`` holds this rank's blocks,
    laid out as ``specs``, and each leaf is cut to its block."""
    candidates = [name] if name else [BUNDLE, BUNDLE_PREV]
    for cand in candidates:
        path = os.path.join(exp_dir, cand)
        if not os.path.exists(path):
            continue
        saved = _read_bundle(path, mmap=mesh is not None)
        leaves = saved["state"]
        spec_of = {}
        if mesh is not None:
            from ..parallel import mesh as mesh_mod

            spec_of = {keystr(p): s for p, s in leaves_with_path(specs)}

        def take(p, like):
            t = leaves[keystr(p)]
            if mesh is not None:
                t = mesh_mod.local_part(t, spec_of[keystr(p)], mesh)
            if t.shape != like.shape or t.dtype != like.dtype:
                raise ValueError(f"{path}: {keystr(p)} is {t.dtype} "
                                 f"{tuple(t.shape)}, the state wants "
                                 f"{like.dtype} {tuple(like.shape)}")
            return t.to(like.device)

        state = tree_map_with_path(take, template)
        progress: Dict[str, Any] = {}
        pf = os.path.join(exp_dir, PROGRESS)
        if os.path.isfile(pf):
            with open(pf) as f:
                progress = json.load(f)
        log.info("restored checkpoint from %s (step %s)", path,
                 progress.get("step"))
        return state, progress, saved.get("loader")
    raise FileNotFoundError(f"no checkpoint found under {exp_dir}")


def has_bundle(exp_dir: str) -> bool:
    return any(os.path.exists(os.path.join(exp_dir, n))
               for n in (BUNDLE, BUNDLE_PREV))


def save_config(exp_dir: str, cfg: Any, fname: str = "config.json") -> None:
    os.makedirs(exp_dir, exist_ok=True)
    with open(os.path.join(exp_dir, fname), "w") as f:
        json.dump(dataclasses.asdict(cfg), f, indent=2, default=str)
