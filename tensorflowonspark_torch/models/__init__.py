"""Model zoo of the port (the counterpart of
:mod:`tensorflowonspark_tpu.models`).

The registry maps exported model names back to constructors, so a server
can rebuild a model from an export's name and config alone.  It holds the
transformer LM (:mod:`~tensorflowonspark_torch.models.transformer`), the
MNIST CNN (:mod:`~tensorflowonspark_torch.models.mnist`), the linear model
(:mod:`~tensorflowonspark_torch.models.linear`), the two-tower model
(:mod:`~tensorflowonspark_torch.models.twotower`) and the ResNets
(:mod:`~tensorflowonspark_torch.models.resnet`: ``resnet50``, ResNet-50
v1.5 with the conv7 or s2d stem, and ``resnet56_cifar``), whose BatchNorm
running averages are the Trainer's extra state, not params, and the U-Net
(:mod:`~tensorflowonspark_torch.models.unet`, ``unet``).

flax infers a Dense layer's input width from the first call; a torch layer
needs it at construction.  A model registered with ``widths=`` reads those
widths from a ``state_dict``'s shapes: ``get_model(name, state_dict=sd,
**config)`` passes them to the constructor, so an export's descriptor
keeps the JAX ``model_config`` unchanged.
"""

_REGISTRY = {}
_WIDTHS = {}


def register_model(name, widths=None):
    """Register a constructor under ``name``; ``widths(state_dict)``, when
    given, returns the constructor arguments a state dict's shapes fix."""
    def deco(fn):
        _REGISTRY[name] = fn
        if widths is not None:
            _WIDTHS[name] = widths
        return fn
    return deco


def get_model(name, state_dict=None, **config):
    """Instantiate a registered model by name; with ``state_dict``, sized to
    its shapes where the model registered ``widths``."""
    if name not in _REGISTRY:
        raise KeyError("unknown model {!r}; registered: {}".format(
            name, sorted(_REGISTRY)))
    if state_dict is not None and name in _WIDTHS:
        config = dict(config, **_WIDTHS[name](state_dict))
    return _REGISTRY[name](**config)


# Import for registration side effects.
from tensorflowonspark_torch.models import (  # noqa: E402,F401
    linear, mnist, resnet, transformer, twotower, unet)
