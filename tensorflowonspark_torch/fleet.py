"""The model fleet of the port (the counterpart of
:mod:`tensorflowonspark_tpu.fleet`).

So far it holds only :class:`SwapRefused`, which
:meth:`~tensorflowonspark_torch.serving.ModelServer.swap_export` raises.
The fleet half of ROADMAP item G fills the rest of it: the model registry,
the fleet router and client, the canary controller and
``publish_from_training``, after the observability planes (item D) that
the JAX fleet is built on.
"""


class SwapRefused(ValueError):
    """A live swap was refused (incompatible params/signature: applying
    it would rebuild the model or corrupt outputs)."""
