"""Two-tower retrieval model of the port (the counterpart of
:mod:`tensorflowonspark_tpu.models.twotower`): the zoo's multi-input,
multi-output family.

Two named inputs (``user``, ``item``), a dense tower over each, and two
named outputs (``score``, the towers' dot product, and ``user_embedding``),
both fp32.  As in flax, the params stay fp32 and the towers compute in
``dtype`` (inputs and params cast to it).  The towers' input widths come
from the state dict when a server rebuilds an export (the registry's
``widths``).
"""

import torch
import torch.nn.functional as F
from torch import nn

from tensorflowonspark_torch.models import register_model


def _dense(x, layer, dtype):
    return F.linear(x.to(dtype), layer.weight.to(dtype), layer.bias.to(dtype))


class TwoTower(nn.Module):
    def __init__(self, user_features, item_features, embed_dim=8,
                 dtype=torch.float32):
        super().__init__()
        self.dtype = dtype
        self.user_tower = nn.Linear(user_features, embed_dim)
        self.item_tower = nn.Linear(item_features, embed_dim)

    def forward(self, user, item):
        u = _dense(user, self.user_tower, self.dtype)
        v = _dense(item, self.item_tower, self.dtype)
        score = (u * v).sum(dim=-1).float()
        return {"score": score, "user_embedding": u.float()}


def _widths(state_dict):
    return {"user_features": int(state_dict["user_tower.weight"].shape[1]),
            "item_features": int(state_dict["item_tower.weight"].shape[1])}


@register_model("two_tower", widths=_widths)
def build_two_tower(embed_dim=8, dtype="float32", user_features=None,
                    item_features=None):
    if user_features is None or item_features is None:
        raise ValueError("two_tower needs user_features and item_features "
                         "(flax infers them from the data; get_model(..., "
                         "state_dict=sd) reads them from a state dict)")
    return TwoTower(user_features, item_features, embed_dim=embed_dim,
                    dtype=getattr(torch, dtype))


def loss_fn(model):
    """Masked MSE on the score head, for the Trainer contract.  The batch
    carries ``user`` / ``item`` inputs and a ``label`` target score."""

    def loss(params, batch, mask):
        out = torch.func.functional_call(
            model, params, (), {"user": batch["user"], "item": batch["item"]})
        err = (out["score"] - batch["label"]) ** 2
        mask = mask.to(err.dtype)
        mse = (err * mask).sum() / mask.sum().clamp_min(1.0)
        return mse, {}

    return loss
