"""Device resolution for the port (the counterpart of
:mod:`tensorflowonspark_tpu.device_info`).

Entry points run on the CUDA card unless the caller asks for the CPU.  With
no card and no explicit ``"cpu"`` they raise: work never moves to the CPU
silently.
"""

import torch


def resolve_device(device=None):
    """The ``torch.device`` to run on: ``cuda:0`` by default.

    Raises ``RuntimeError`` when a CUDA device is asked for (or defaulted
    to) and CUDA is not available; ``device="cpu"`` is the only way to the
    CPU."""
    dev = torch.device("cuda:0" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' to run on "
                "the CPU")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    elif dev.type != "cpu":
        raise ValueError("device must be cuda or cpu, got {!r}".format(device))
    return dev


def device_report():
    """``{"name", "count"}`` of the CUDA cards this process sees."""
    return {"name": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count()}
