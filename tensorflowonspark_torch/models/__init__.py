"""Model zoo of the port (the counterpart of
:mod:`tensorflowonspark_tpu.models`).

The registry maps exported model names back to constructors, so a server
can rebuild a model from an export's name and config alone.  So far it
holds the transformer LM (:mod:`~tensorflowonspark_torch.models.transformer`)
and the MNIST CNN (:mod:`~tensorflowonspark_torch.models.mnist`).
"""

_REGISTRY = {}


def register_model(name):
    def deco(fn):
        _REGISTRY[name] = fn
        return fn
    return deco


def get_model(name, **config):
    """Instantiate a registered model by name."""
    if name not in _REGISTRY:
        raise KeyError("unknown model {!r}; registered: {}".format(
            name, sorted(_REGISTRY)))
    return _REGISTRY[name](**config)


# Import for registration side effects.
from tensorflowonspark_torch.models import mnist, transformer  # noqa: E402,F401
