"""Weight conversion between the JAX package's flax param trees and the
port's ``state_dict``s.

Trees are plain nested dicts of numpy arrays (what ``jax.device_get`` of a
flax ``params`` collection gives); state dicts map names to fp32 tensors
(fp64 for fp64 leaves).
Layouts:

- ``Dense`` kernel ``(in, out)`` <-> ``Linear``-style ``weight`` ``(out, in)``;
- the attention ``DenseGeneral`` qkv kernel ``(d, 3, H, Dh)`` and bias
  ``(3, H, Dh)`` <-> one ``(3*H*Dh, d)`` weight and ``(3*H*Dh,)`` bias, the
  ``(3, H, Dh)`` order kept;
- ``LayerNorm`` ``scale``/``bias`` <-> ``weight``/``bias``;
- ``Embed`` ``embedding`` <-> ``weight``;
- an MoE block's ``moe`` subtree: the ``router`` Dense as above, the
  expert tensors ``w1``, ``b1``, ``w2``, ``b2`` as they are;
- ``Conv`` kernel ``(H, W, in, out)`` (HWIO) <-> ``Conv2d`` ``weight``
  ``(out, in, H, W)`` (OIHW);
- ``BatchNorm`` ``scale``/``bias`` <-> ``weight``/``bias``, and its
  ``batch_stats`` ``mean``/``var`` <-> the buffers ``running_mean``/
  ``running_var`` (the Trainer's extra state, a dict of its own);
- ``ConvTranspose`` kernel ``(H, W, in, out)`` <-> ``conv_transpose2d``
  ``weight`` ``(in, out, H, W)`` flipped in both spatial axes (flax's
  ``transpose_kernel=False`` correlates, torch's transpose convolves);
- ``GroupNorm`` ``scale``/``bias`` <-> ``weight``/``bias``.

Every model the port registers round-trips.
"""

import numpy as np
import torch

# flax path under block_<i> -> torch name under blocks.<i>
_BLOCK_DENSE = {("Attention_0", "qkv"): "attn.qkv",
                ("Attention_0", "proj"): "attn.proj",
                ("Dense_0",): "mlp_in",
                ("Dense_1",): "mlp_out"}
_BLOCK_NORM = {"LayerNorm_0": "ln1", "LayerNorm_1": "ln2"}
_MOE_DENSE = (("Dense_0",), ("Dense_1",))
_MOE_EXPERTS = ("w1", "b1", "w2", "b2")


def _t(x):
    """fp32, or fp64 when given fp64 (the float64 parity tests)."""
    x = np.asarray(x)
    return torch.from_numpy(np.array(
        x, dtype=np.float64 if x.dtype == np.float64 else np.float32))


def _get(tree, path):
    for key in path:
        tree = tree[key]
    return tree


def transformer_params_from_flax(tree):
    """A flax ``TransformerLM`` param tree -> the port's ``state_dict``."""
    sd = {"embed.weight": _t(tree["embed"]["embedding"]),
          "pos_embed.weight": _t(tree["pos_embed"]["embedding"]),
          "ln_f.weight": _t(tree["LayerNorm_0"]["scale"]),
          "ln_f.bias": _t(tree["LayerNorm_0"]["bias"])}
    n_layers = sum(1 for key in tree if key.startswith("block_"))
    for i in range(n_layers):
        block = tree["block_%d" % i]
        prefix = "blocks.%d." % i
        moe = block.get("moe")
        if moe is not None:
            sd[prefix + "moe.router.weight"] = _t(
                np.asarray(moe["router"]["kernel"]).T)
            sd[prefix + "moe.router.bias"] = _t(moe["router"]["bias"])
            for name in _MOE_EXPERTS:
                sd[prefix + "moe." + name] = _t(moe[name])
        for path, name in _BLOCK_DENSE.items():
            if moe is not None and path in _MOE_DENSE:
                continue
            dense = _get(block, path)
            kernel = np.asarray(dense["kernel"])
            sd[prefix + name + ".weight"] = _t(
                kernel.reshape(kernel.shape[0], -1).T)
            sd[prefix + name + ".bias"] = _t(np.asarray(dense["bias"]).ravel())
        for flax_name, name in _BLOCK_NORM.items():
            sd[prefix + name + ".weight"] = _t(block[flax_name]["scale"])
            sd[prefix + name + ".bias"] = _t(block[flax_name]["bias"])
    return sd


def transformer_params_to_flax(state_dict, num_heads):
    """The port's ``state_dict`` -> a flax ``TransformerLM`` param tree of
    numpy arrays.  ``num_heads`` splits the fused qkv projection back into
    ``(3, H, Dh)``."""
    def arr(name):
        return state_dict[name].detach().cpu().float().numpy().copy()

    tree = {"embed": {"embedding": arr("embed.weight")},
            "pos_embed": {"embedding": arr("pos_embed.weight")},
            "LayerNorm_0": {"scale": arr("ln_f.weight"),
                            "bias": arr("ln_f.bias")}}
    n_layers = len({k.split(".")[1] for k in state_dict
                    if k.startswith("blocks.")})
    for i in range(n_layers):
        prefix = "blocks.%d." % i
        block = {}
        moe = prefix + "moe.w1" in state_dict
        if moe:
            block["moe"] = dict(
                router={"kernel": np.ascontiguousarray(
                    arr(prefix + "moe.router.weight").T),
                        "bias": arr(prefix + "moe.router.bias")},
                **{name: arr(prefix + "moe." + name)
                   for name in _MOE_EXPERTS})
        for path, name in _BLOCK_DENSE.items():
            if moe and path in _MOE_DENSE:
                continue
            weight = arr(prefix + name + ".weight").T
            bias = arr(prefix + name + ".bias")
            if name == "attn.qkv":
                d_model = weight.shape[0]
                head_dim = weight.shape[1] // (3 * num_heads)
                weight = weight.reshape(d_model, 3, num_heads, head_dim)
                bias = bias.reshape(3, num_heads, head_dim)
            node = block
            for key in path[:-1]:
                node = node.setdefault(key, {})
            node[path[-1]] = {"kernel": np.ascontiguousarray(weight),
                              "bias": bias}
        for flax_name, name in _BLOCK_NORM.items():
            block[flax_name] = {"scale": arr(prefix + name + ".weight"),
                                "bias": arr(prefix + name + ".bias")}
        tree["block_%d" % i] = block
    return tree


def conv_kernel_to_torch(kernel):
    """A flax ``Conv`` kernel (HWIO) as a ``Conv2d`` weight (OIHW)."""
    return _t(np.asarray(kernel).transpose(3, 2, 0, 1))


def conv_weight_to_flax(weight):
    """A ``Conv2d`` weight (OIHW) as a flax ``Conv`` kernel (HWIO)."""
    return np.ascontiguousarray(
        weight.detach().cpu().float().numpy().transpose(2, 3, 1, 0))


# flax module name -> torch module name in MnistCNN
_MNIST_CONV = {"Conv_0": "conv0", "Conv_1": "conv1"}
_MNIST_DENSE = {"Dense_0": "dense0", "Dense_1": "dense1"}


def mnist_params_from_flax(tree):
    """A flax ``MnistCNN`` param tree -> the port's ``state_dict``."""
    sd = {}
    for flax_name, name in _MNIST_CONV.items():
        sd[name + ".weight"] = conv_kernel_to_torch(tree[flax_name]["kernel"])
        sd[name + ".bias"] = _t(tree[flax_name]["bias"])
    for flax_name, name in _MNIST_DENSE.items():
        sd[name + ".weight"] = _t(np.asarray(tree[flax_name]["kernel"]).T)
        sd[name + ".bias"] = _t(tree[flax_name]["bias"])
    return sd


def mnist_params_to_flax(state_dict):
    """The port's ``MnistCNN`` ``state_dict`` -> a flax param tree of numpy
    arrays."""
    def arr(name):
        return state_dict[name].detach().cpu().float().numpy().copy()

    tree = {}
    for flax_name, name in _MNIST_CONV.items():
        tree[flax_name] = {"kernel": conv_weight_to_flax(
            state_dict[name + ".weight"]), "bias": arr(name + ".bias")}
    for flax_name, name in _MNIST_DENSE.items():
        tree[flax_name] = {"kernel": np.ascontiguousarray(
            arr(name + ".weight").T), "bias": arr(name + ".bias")}
    return tree


def _dense_from_flax(dense):
    return {"weight": _t(np.asarray(dense["kernel"]).T),
            "bias": _t(dense["bias"])}


def _dense_to_flax(state_dict, name):
    weight = state_dict[name + ".weight"].detach().cpu().float().numpy()
    return {"kernel": np.ascontiguousarray(weight.T),
            "bias": state_dict[name + ".bias"].detach().cpu().float()
            .numpy().copy()}


def _dense_tree_from_flax(tree, names):
    sd = {}
    for name in names:
        for key, value in _dense_from_flax(tree[name]).items():
            sd[name + "." + key] = value
    return sd


_LINEAR = ("dense",)
_TWO_TOWER = ("user_tower", "item_tower")


def linear_params_from_flax(tree):
    """A flax ``Linear`` param tree -> the port's ``state_dict``."""
    return _dense_tree_from_flax(tree, _LINEAR)


def linear_params_to_flax(state_dict):
    """The port's ``Linear`` ``state_dict`` -> a flax param tree of numpy
    arrays."""
    return {name: _dense_to_flax(state_dict, name) for name in _LINEAR}


def two_tower_params_from_flax(tree):
    """A flax ``TwoTower`` param tree -> the port's ``state_dict``."""
    return _dense_tree_from_flax(tree, _TWO_TOWER)


def two_tower_params_to_flax(state_dict):
    """The port's ``TwoTower`` ``state_dict`` -> a flax param tree of numpy
    arrays."""
    return {name: _dense_to_flax(state_dict, name) for name in _TWO_TOWER}


# a flax ResNet's top-level modules -> the port's
_RESNET_TOP = {"Conv_0": "stem_conv", "BatchNorm_0": "stem_norm"}
_RESNET_BLOCKS = ("BottleneckBlock", "BasicBlock")


def _resnet_modules(tree):
    """``(flax path, torch prefix)`` of every Conv and BatchNorm of a flax
    ResNet tree: the stem's, then each ``<Block>_<n>``'s ``Conv_k`` /
    ``BatchNorm_k`` as ``blocks.<n>.convs.k`` / ``blocks.<n>.norms.k``."""
    out = [((key,), name) for key, name in _RESNET_TOP.items()]
    for key in tree:
        kind, _, index = key.rpartition("_")
        if kind not in _RESNET_BLOCKS:
            continue
        for sub in tree[key]:
            layer, _, k = sub.rpartition("_")
            name = {"Conv": "convs", "BatchNorm": "norms"}[layer]
            out.append(((key, sub), "blocks.{}.{}.{}".format(index, name, k)))
    return out


def resnet_params_from_flax(params, batch_stats):
    """A flax ``ResNet``'s ``params`` and ``batch_stats`` trees -> the port's
    ``(params, extra)`` name -> tensor dicts (the Trainer's
    ``init_params`` and ``extra_state``; together the model's
    ``state_dict``)."""
    sd, extra = {}, {}
    for path, name in _resnet_modules(params):
        node = _get(params, path)
        if path[-1].startswith("Conv"):
            sd[name + ".weight"] = conv_kernel_to_torch(node["kernel"])
            continue
        sd[name + ".weight"] = _t(node["scale"])
        sd[name + ".bias"] = _t(node["bias"])
        stats = _get(batch_stats, path)
        extra[name + ".running_mean"] = _t(stats["mean"])
        extra[name + ".running_var"] = _t(stats["var"])
    for key, value in _dense_from_flax(params["Dense_0"]).items():
        sd["head." + key] = value
    return sd, extra


def resnet_params_to_flax(state_dict, extra):
    """The port's ResNet ``(params, extra)`` dicts -> flax ``(params,
    batch_stats)`` trees of numpy arrays.  The block kind is read from the
    first block's first kernel: 1x1 for a bottleneck, 3x3 for a basic
    block."""
    def arr(tree, name):
        return tree[name].detach().cpu().float().numpy().copy()

    first = state_dict.get("blocks.0.convs.0.weight")
    block = ("BottleneckBlock" if first is None or first.shape[-1] == 1
             else "BasicBlock")
    params, stats = {}, {}
    for name in state_dict:
        parts = name.split(".")
        if parts[0] == "head":
            continue
        if parts[0] == "blocks":
            layer = {"convs": "Conv", "norms": "BatchNorm"}[parts[2]]
            path = ("{}_{}".format(block, parts[1]),
                    "{}_{}".format(layer, parts[3]))
        else:
            path = ({v: k for k, v in _RESNET_TOP.items()}[parts[0]],)
        node = params
        for key in path:
            node = node.setdefault(key, {})
        prefix = name.rsplit(".", 1)[0]
        if path[-1].startswith("Conv"):
            node["kernel"] = conv_weight_to_flax(state_dict[name])
        elif name.endswith(".weight"):
            node["scale"] = arr(state_dict, name)
            node["bias"] = arr(state_dict, prefix + ".bias")
            snode = stats
            for key in path:
                snode = snode.setdefault(key, {})
            snode["mean"] = arr(extra, prefix + ".running_mean")
            snode["var"] = arr(extra, prefix + ".running_var")
    params["Dense_0"] = _dense_to_flax(state_dict, "head")
    return params, stats


def conv_transpose_kernel_to_torch(kernel):
    """A flax ``ConvTranspose`` kernel (HWIO) as the port's
    ``conv_transpose2d`` weight ``(in, out, H, W)``, flipped."""
    return _t(np.asarray(kernel)[::-1, ::-1].transpose(2, 3, 0, 1))


def conv_transpose_weight_to_flax(weight):
    """The inverse of :func:`conv_transpose_kernel_to_torch`."""
    return np.ascontiguousarray(
        weight.detach().cpu().float().numpy().transpose(2, 3, 0, 1)
        [::-1, ::-1])


# a flax UNet's top-level convs and block kinds -> the port's module names
_UNET_CONV = {"Conv_0": "conv_in", "Conv_1": "conv_out"}
_UNET_BLOCKS = {"DownBlock": ("down", "Conv_0"),
                "UpBlock": ("up", "ConvTranspose_0")}


def unet_params_from_flax(tree):
    """A flax ``UNet`` param tree -> the port's ``state_dict``."""
    sd = {}
    for flax_name, name in _UNET_CONV.items():
        sd[name + ".weight"] = conv_kernel_to_torch(tree[flax_name]["kernel"])
        sd[name + ".bias"] = _t(tree[flax_name]["bias"])
    for key, block in tree.items():
        kind, _, index = key.rpartition("_")
        if kind not in _UNET_BLOCKS:
            continue
        prefix, conv = _UNET_BLOCKS[kind]
        name = "{}.{}.".format(prefix, index)
        kernel = block[conv]["kernel"]
        sd[name + "conv.weight"] = (
            conv_kernel_to_torch(kernel) if kind == "DownBlock"
            else conv_transpose_kernel_to_torch(kernel))
        sd[name + "norm.weight"] = _t(block["GroupNorm_0"]["scale"])
        sd[name + "norm.bias"] = _t(block["GroupNorm_0"]["bias"])
    return sd


def unet_params_to_flax(state_dict):
    """The port's ``UNet`` ``state_dict`` -> a flax param tree of numpy
    arrays."""
    def arr(name):
        return state_dict[name].detach().cpu().float().numpy().copy()

    tree = {}
    for flax_name, name in _UNET_CONV.items():
        tree[flax_name] = {"kernel": conv_weight_to_flax(
            state_dict[name + ".weight"]), "bias": arr(name + ".bias")}
    for kind, (prefix, conv) in _UNET_BLOCKS.items():
        i = 0
        while "{}.{}.conv.weight".format(prefix, i) in state_dict:
            name = "{}.{}.".format(prefix, i)
            weight = state_dict[name + "conv.weight"]
            tree["{}_{}".format(kind, i)] = {
                conv: {"kernel": conv_weight_to_flax(weight)
                       if kind == "DownBlock"
                       else conv_transpose_weight_to_flax(weight)},
                "GroupNorm_0": {"scale": arr(name + "norm.weight"),
                                "bias": arr(name + "norm.bias")}}
            i += 1
    return tree
