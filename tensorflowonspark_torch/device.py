"""Device resolution and card placement for the port (the counterpart of
:mod:`tensorflowonspark_tpu.device_info`, which in turn stands for the
original system's ``gpu_info.py``).

Entry points run on the CUDA card unless the caller asks for the CPU.  With
no card and no explicit ``"cpu"`` they raise: work never moves to the CPU
silently.
"""

import logging
import os

import torch

logger = logging.getLogger(__name__)

#: what :func:`pin_cards` set ``CUDA_VISIBLE_DEVICES`` to, so that
#: :func:`cards_pinned` can tell a pinned worker from one that inherited
#: a host-wide list
PINNED_ENV = "TFOS_PINNED_CARDS"


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


def num_local_cards():
    """Number of CUDA cards this process sees (after any
    ``CUDA_VISIBLE_DEVICES`` pinning).  It asks the CUDA driver, so call it
    where CUDA may start: in a node's user fn, never before the node's
    forks."""
    return torch.cuda.device_count()


def pin_cards(worker_index, cards_per_worker, total_cards=None):
    """Bind this process to a deterministic subset of the host's cards.

    The counterpart of the JAX package's ``device_info.pin_chips`` and of
    the original system's by-worker-index GPU placement for several
    workers per host (``gpu_info.py:91-102``): worker ``i`` gets cards
    ``[i*cards_per_worker, (i+1)*cards_per_worker)`` by setting
    ``CUDA_VISIBLE_DEVICES``.  When the variable is already set, the
    indices pick from the cards it lists.  ``total_cards``, when given,
    bounds the request.

    It must run before CUDA initializes in this process (CUDA reads the
    variable once); it raises ``RuntimeError`` otherwise.  It only sets an
    environment variable and makes no CUDA call.  Returns the card ids now
    visible, as the host numbers them."""
    if torch.cuda.is_initialized():
        raise RuntimeError(
            "pin_cards must run before CUDA initializes in this process")
    first = worker_index * cards_per_worker
    wanted = list(range(first, first + cards_per_worker))
    inherited = os.environ.get("CUDA_VISIBLE_DEVICES")
    host_cards = ([c.strip() for c in inherited.split(",") if c.strip()]
                  if inherited else None)
    limit = len(host_cards) if host_cards is not None else total_cards
    if total_cards is not None and limit is not None:
        limit = min(limit, total_cards)
    if limit is not None and wanted[-1] >= limit:
        raise ValueError(
            "worker {} requests cards {} beyond this host's {} cards".format(
                worker_index, wanted, limit))
    cards = ([host_cards[i] for i in wanted] if host_cards is not None
             else [str(i) for i in wanted])
    os.environ["CUDA_VISIBLE_DEVICES"] = ",".join(cards)
    os.environ[PINNED_ENV] = os.environ["CUDA_VISIBLE_DEVICES"]
    logger.info("pinned worker %d to cards %s", worker_index, cards)
    return cards


def cards_pinned():
    """Whether this process's ``CUDA_VISIBLE_DEVICES`` is the list that
    :func:`pin_cards` set (and not changed since)."""
    pinned = os.environ.get(PINNED_ENV)
    return bool(pinned) and pinned == os.environ.get("CUDA_VISIBLE_DEVICES")


def default_card(local_rank, visible_cards, pinned):
    """The index of a node's default card among the ``visible_cards`` this
    process sees: its first card when :func:`pin_cards` pinned this
    worker's own cards (the JAX package's ``pin_chips`` leaves a process
    only its own chips too), else ``local_rank`` (every node on the host
    sees every card).  Raises ``ValueError`` when that card is not
    visible."""
    index = 0 if pinned else local_rank
    if index >= visible_cards:
        raise ValueError(
            "local rank {} has no card of its own among the {} visible "
            "(pin_cards, or CUDA_VISIBLE_DEVICES listing every card of "
            "the host)".format(local_rank, visible_cards))
    return index
