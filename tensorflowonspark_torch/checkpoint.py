"""Serving export of the port (the counterpart of the export half of
:mod:`tensorflowonspark_tpu.checkpoint`).

An export is a directory holding ``export.json`` (the same descriptor keys
as the JAX package: ``model_name``, ``model_config``, ``input_signature``)
and ``params.pt``, the model's ``state_dict`` written by ``torch.save``.
There is no compiled artifact: a server rebuilds the model from the
registry by name and config.
"""

import json
import logging
import os

import torch

logger = logging.getLogger(__name__)

_DESCRIPTOR = "export.json"
_PARAMS_FILE = "params.pt"


def _fs_path(path):
    """A local path, with any ``file://`` / ``file:`` scheme stripped."""
    if path.startswith("file://"):
        path = path[len("file://"):] or "/"
    elif path.startswith("file:"):
        path = path[len("file:"):]
    return os.path.abspath(path)


def _nonfinite_leaves(state_dict):
    """Names of floating-point tensors holding any NaN or Inf."""
    return [name for name, t in state_dict.items()
            if torch.is_floating_point(t) and not bool(torch.isfinite(t).all())]


def export_model(export_dir, params, model_name, model_config=None,
                 input_signature=None):
    """Export ``params`` (a ``state_dict`` or an ``nn.Module``) and the
    model descriptor for serving."""
    if isinstance(params, torch.nn.Module):
        params = params.state_dict()
    export_dir = _fs_path(export_dir)
    os.makedirs(export_dir, exist_ok=True)
    state = {name: t.detach().cpu().contiguous() for name, t in params.items()}
    path = os.path.join(export_dir, _PARAMS_FILE)
    torch.save(state, path + ".tmp")
    os.replace(path + ".tmp", path)
    descriptor = {
        "model_name": model_name,
        "model_config": model_config or {},
        "input_signature": input_signature or {},
    }
    with open(os.path.join(export_dir, _DESCRIPTOR), "w") as f:
        json.dump(descriptor, f)
    logger.info("exported %s to %s", model_name, export_dir)


def load_model(export_dir, validate=False):
    """Load an export: returns ``(state_dict, descriptor_dict)``, the
    tensors on the CPU.

    ``validate=True`` raises ``ValueError`` when any param holds NaN or
    Inf, so a poisoned export is refused before it serves."""
    export_dir = _fs_path(export_dir)
    with open(os.path.join(export_dir, _DESCRIPTOR)) as f:
        descriptor = json.load(f)
    state = torch.load(os.path.join(export_dir, _PARAMS_FILE),
                       map_location="cpu", weights_only=True)
    if validate:
        bad = _nonfinite_leaves(state)
        if bad:
            raise ValueError("export {} has nonfinite params at {}".format(
                export_dir, bad[:4]))
    return state, descriptor
