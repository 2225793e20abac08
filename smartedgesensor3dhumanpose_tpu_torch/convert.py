"""Conversions between host arrays and the port's types.

What crosses between the JAX package and the port: the calibration, the
frames, the carried TrackerState, the keypoint detector's weights and its
optimizer state. Field names and layouts match the JAX package's types, so
a state taken from a JAX run mid-sequence (as numpy) continues in the port,
a flax parameter tree of the detector loads into
`models.keypoint_cnn.KeypointCNN`, and training taken from optax mid-run
continues in `models.train` (and back).
Like every entry point of the port, these place their tensors on the card
unless the caller asks for the CPU (`device="cpu"`).
"""

from __future__ import annotations

import numpy as np
import torch

from smartedgesensor3dhumanpose_tpu_torch import cameras
from smartedgesensor3dhumanpose_tpu_torch.models.train import AdamState
from smartedgesensor3dhumanpose_tpu_torch.types import CameraRig, Frame, TrackerState

_STATE_INT = {"track_id", "num_obs", "next_id", "frame_nr"}
_STATE_BOOL = {"alive", "est_exists"}


def rig_from_numpy(K, P, image_size=(640, 480), dtype=torch.float32,
                   device="cuda") -> CameraRig:
    """CameraRig from intrinsics K ([C, 4] or [C, 3, 3]) and extrinsics P
    [C, 3, 4]; the fundamental matrices are recomputed in float64."""
    return cameras.build_rig(P, K, image_size, dtype=dtype, device=device)


def frame_from_arrays(data: dict, device="cuda") -> Frame:
    """Frame from a dict of host arrays (see Frame.from_arrays)."""
    return Frame.from_arrays(data, device)


def tracker_state_from_numpy(arrays: dict, device="cuda", dtype=None) -> TrackerState:
    """TrackerState from a dict of arrays named like its fields. Float
    fields keep their dtype unless `dtype` is given; ids and counters become
    int32, masks bool."""
    fields = {}
    for name in TrackerState._fields:
        a = np.array(arrays[name])  # a writable copy
        if name in _STATE_INT:
            t = torch.as_tensor(a.astype(np.int32), device=device)
        elif name in _STATE_BOOL:
            t = torch.as_tensor(a.astype(bool), device=device)
        else:
            t = torch.as_tensor(a, device=device)
            if dtype is not None:
                t = t.to(dtype)
        fields[name] = t
    return TrackerState(**fields)


def host(x) -> np.ndarray:
    """A numpy array of a tensor on any device, or of an array-like."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def tree_to(tree, device):
    """A tensor, or a (named) tuple of them nested, moved to `device`."""
    if isinstance(tree, torch.Tensor):
        return tree.to(device)
    values = [tree_to(x, device) for x in tree]
    return type(tree)(*values) if hasattr(tree, "_fields") else type(tree)(values)


def tracker_state_to_numpy(state: TrackerState) -> dict:
    """Dict of numpy arrays, one per TrackerState field."""
    return {
        name: getattr(state, name).detach().cpu().numpy()
        for name in TrackerState._fields
    }


def detector_params_from_flax(params) -> dict:
    """A `KeypointCNN` state_dict (CPU tensors) from the JAX package's flax
    parameter tree of the same DetectorConfig (`{"params": {...}}` or its
    inner dict), as numpy or any array type: conv kernels HWIO -> OIHW,
    GroupNorm `scale` -> `weight`, biases as they are."""
    tree = params.get("params", params)
    state = {}
    for name, leaves in tree.items():
        for leaf, value in leaves.items():
            a = np.array(value)  # a writable copy
            if leaf == "kernel":
                state[f"{name}.weight"] = torch.from_numpy(a.transpose(3, 2, 0, 1).copy())
            elif leaf == "scale":
                state[f"{name}.weight"] = torch.from_numpy(a)
            elif leaf == "bias":
                state[f"{name}.bias"] = torch.from_numpy(a)
            else:
                raise KeyError(f"unknown detector parameter {name}/{leaf}")
    return state


def detector_params_to_flax(state_dict: dict) -> dict:
    """The inverse of `detector_params_from_flax`: `{"params": {...}}` of
    numpy arrays (OIHW -> HWIO; a GroupNorm's `weight` -> `scale`)."""
    tree: dict = {}
    for key, value in state_dict.items():
        name, leaf = key.split(".")
        a = value.detach().cpu().numpy()
        if leaf == "weight" and a.ndim == 4:
            tree.setdefault(name, {})["kernel"] = a.transpose(2, 3, 1, 0).copy()
        elif leaf == "weight":
            tree.setdefault(name, {})["scale"] = a.copy()
        else:
            tree.setdefault(name, {})["bias"] = a.copy()
    return {"params": tree}


def adam_state_from_optax(opt_state, names, device="cuda") -> AdamState:
    """The port's AdamState (models/train.py) from optax.adam's state
    `(ScaleByAdamState(count, mu, nu), EmptyState())`, as numpy or any
    array type: the moments' flax trees converted as
    `detector_params_from_flax` converts the parameters and taken in the
    order of `names` (`train.param_names`), the count an int32 0-d tensor."""
    adam = opt_state[0]

    def moments(tree):
        state = detector_params_from_flax(tree)
        return tuple(state[n].to(device) for n in names)

    count = torch.as_tensor(np.array(adam.count, dtype=np.int32), device=device)
    return AdamState(count, moments(adam.mu), moments(adam.nu))


def adam_state_to_optax(state: AdamState, names) -> tuple:
    """The inverse of `adam_state_from_optax`: `(AdamState(count, mu, nu),
    ())` of a numpy int32 count and `{"params": {...}}` trees of numpy
    moments. It has the field names and leaves of optax.adam's
    `(ScaleByAdamState, EmptyState())`, so optax takes it as its state and
    its leaves flatten in optax's order."""

    def tree(moments):
        return detector_params_to_flax(dict(zip(names, moments, strict=True)))

    count = np.array(host(state.count), dtype=np.int32)
    return AdamState(count, tree(state.mu), tree(state.nu)), ()
