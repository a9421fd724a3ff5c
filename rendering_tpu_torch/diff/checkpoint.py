"""Checkpoints of long renders and of inverse-rendering runs — the port's
counterpart of `rendering_tpu.diff.checkpoint`, in the same npz layout.

The file is one `.npz` (numpy's savez; read back with allow_pickle off):

    step              () int64, the step (or the strips) done
    params__treedef   uint8: the UTF-8 bytes of the parameters' structure
                      string
    params__<i>       the i-th tensor of the parameters, in that order
    opt__treedef      the same for the optimizer state
    opt__<i>
    frame             optional: a partly accumulated (3, H*W) f32 frame
    tile_mask         optional: (n_strips,) bool, the strips it holds
    meta__<key>       optional scalars and arrays (render_resumable: the
                      scene fingerprint, the queue headroom, the counters)

`params` is the port's parameter dict (`diff.inverse.extract_params`:
"/"-joined path -> leaf tensor); `opt_state` is the torch optimizer
(`make_train_step`'s init_fn), saved through its `state_dict()`, or a
plain dict of tensors (`{}` for a render). A structure string is the
`repr` of the tree with each tensor replaced by ("__tensor__", i) and
each non-finite float by ("__float__", repr): it restores the tree with
`ast.literal_eval`, and it is checked on load the way the JAX package
checks its treedef, so a renamed or reordered parameter, or an optimizer
over other parameter groups, raises instead of loading into the wrong
slot. The file is written to a `.tmp` sibling and renamed over the
target, so a run stopped while writing leaves the previous checkpoint.

`load_checkpoint` restores in place: the template parameters' values are
overwritten (their tensors, dtypes, devices and requires_grad stay, so an
optimizer built over them keeps stepping them) and the template optimizer
loads the saved state (`load_state_dict`). A run resumed from a
checkpoint after k steps then takes the same steps as one that never
stopped.
"""

from __future__ import annotations

import ast
import math
import os

import numpy as np
import torch

_TENSOR = "__tensor__"
_FLOAT = "__float__"


def _numpy(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def _encode(tree, leaves: list | None = None, count=None):
    """The tree with the i-th tensor replaced by (_TENSOR, i) (appended to
    `leaves` as numpy, when given) and non-finite floats by (_FLOAT,
    repr)."""
    count = count if count is not None else [0]
    if isinstance(tree, torch.Tensor):
        if leaves is not None:
            leaves.append(_numpy(tree))
        count[0] += 1
        return (_TENSOR, count[0] - 1)
    if isinstance(tree, float) and not math.isfinite(tree):
        return (_FLOAT, repr(tree))
    if isinstance(tree, dict):
        return {k: _encode(v, leaves, count) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_encode(v, leaves, count) for v in tree)
    if tree is None or isinstance(tree, (bool, int, float, str)):
        return tree
    raise TypeError(f"cannot checkpoint a {type(tree).__name__}")


def _decode(tree, data, prefix: str):
    if isinstance(tree, tuple) and len(tree) == 2 and tree[0] == _TENSOR:
        return torch.from_numpy(np.array(data[f"{prefix}__{tree[1]}"]))
    if isinstance(tree, tuple) and len(tree) == 2 and tree[0] == _FLOAT:
        return float(tree[1])
    if isinstance(tree, dict):
        return {k: _decode(v, data, prefix) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_decode(v, data, prefix) for v in tree)
    return tree


def _state(opt_state):
    """The saved tree of an optimizer (its state_dict) or a plain tree."""
    if isinstance(opt_state, torch.optim.Optimizer):
        return opt_state.state_dict()
    return opt_state


def _flatten(tree, prefix: str, out: dict) -> None:
    leaves: list = []
    structure = repr(_encode(tree, leaves))
    out[f"{prefix}__treedef"] = np.frombuffer(structure.encode(),
                                              dtype=np.uint8)
    for i, leaf in enumerate(leaves):
        out[f"{prefix}__{i}"] = leaf


def save_checkpoint(path: str, step: int, params, opt_state,
                    frame=None, tile_mask=None, meta: dict | None = None
                    ) -> None:
    """Write the checkpoint (module docstring). frame and tile_mask may
    be tensors or arrays; meta is a flat dict of scalars or arrays, read
    back with load_checkpoint_meta."""
    out: dict = {"step": np.asarray(step)}
    _flatten(params, "params", out)
    _flatten(_state(opt_state), "opt", out)
    if frame is not None:
        out["frame"] = _numpy(frame)
    if tile_mask is not None:
        out["tile_mask"] = _numpy(tile_mask)
    for k, v in (meta or {}).items():
        out[f"meta__{k}"] = _numpy(v)
    # np.savez appends ".npz" to a path without it; write to a .tmp
    # sibling and rename it over the target.
    tmp = path + ".tmp"
    np.savez(tmp, **out)
    os.replace(tmp + ".npz", path)


def load_checkpoint_meta(path: str) -> dict:
    """The meta dict saved with save_checkpoint (empty if none)."""
    with np.load(path, allow_pickle=False) as data:
        pre = "meta__"
        return {k[len(pre):]: data[k] for k in data.files
                if k.startswith(pre)}


def _saved_tree(data, prefix: str):
    structure = bytes(data[f"{prefix}__treedef"]).decode()
    return structure, _decode(ast.literal_eval(structure), data, prefix)


def _groups(state_dict) -> list:
    """An optimizer state's group skeleton: hyperparameter names and the
    parameter ids of each group."""
    return [(sorted(k for k in g if k != "params"), list(g["params"]))
            for g in state_dict.get("param_groups", ())]


def load_checkpoint(path: str, params_like, opt_state_like):
    """Restore a checkpoint into the templates, in place (module
    docstring). Returns (step, params, opt_state, frame, tile_mask):
    the templates themselves, restored, and the frame and tile mask as
    numpy arrays (None when not saved). Raises ValueError when the saved
    parameter structure or optimizer groups differ from the templates'."""
    with np.load(path, allow_pickle=False) as data:
        step = int(data["step"])
        saved_p, p_tree = _saved_tree(data, "params")
        want_p = repr(_encode(params_like))
        if saved_p != want_p:
            raise ValueError(f"checkpoint params structure mismatch:\n"
                             f"  saved:    {saved_p}\n  template: {want_p}")
        _, o_tree = _saved_tree(data, "opt")
        frame = np.array(data["frame"]) if "frame" in data.files else None
        tile_mask = (np.array(data["tile_mask"])
                     if "tile_mask" in data.files else None)
    with torch.no_grad():
        for k, t in params_like.items():
            t.copy_(p_tree[k])
    if isinstance(opt_state_like, torch.optim.Optimizer):
        want_g = _groups(opt_state_like.state_dict())
        if _groups(o_tree) != want_g:
            raise ValueError(f"checkpoint optimizer structure mismatch:\n"
                             f"  saved:    {_groups(o_tree)}\n"
                             f"  template: {want_g}")
        opt_state_like.load_state_dict(o_tree)
        opt_state = opt_state_like
    else:
        want_o = repr(_encode(opt_state_like))
        saved_o = repr(_encode(o_tree))
        if saved_o != want_o:
            raise ValueError(f"checkpoint opt structure mismatch:\n"
                             f"  saved:    {saved_o}\n  template: {want_o}")
        opt_state = o_tree
    return step, params_like, opt_state, frame, tile_mask
