"""Linear regression model of the port (the counterpart of
:mod:`tensorflowonspark_tpu.models.linear`): the pipeline test workload
and the serving gateway's smallest export.

One dense layer ``dense`` (``weight`` ``[features, in_features]``, the flax
kernel transposed).  flax infers the input width from the data; here it is
``in_features``, which a server rebuilding an export reads from the state
dict's ``dense.weight`` (the registry's ``widths``).
"""

import torch
from torch import nn

from tensorflowonspark_torch.models import register_model


class Linear(nn.Module):
    def __init__(self, in_features, features=1):
        super().__init__()
        self.dense = nn.Linear(in_features, features)

    def forward(self, x):
        return self.dense(x)


def _widths(state_dict):
    return {"in_features": int(state_dict["dense.weight"].shape[1])}


@register_model("linear", widths=_widths)
def build_linear(features=1, in_features=None):
    if in_features is None:
        raise ValueError("linear needs in_features (flax infers it from the "
                         "data; get_model(..., state_dict=sd) reads it from "
                         "a state dict)")
    return Linear(in_features, features=features)


def loss_fn(model):
    """Masked mean-squared error for the Trainer contract
    (``fn(params, batch, mask) -> (loss, aux)``)."""

    def loss(params, batch, mask):
        preds = torch.func.functional_call(model, params, (batch["x"],))[:, 0]
        err = (preds - batch["y"]) ** 2
        mask = mask.to(err.dtype)
        mse = (err * mask).sum() / mask.sum().clamp_min(1.0)
        return mse, {}

    return loss
