"""A training step captured once as a CUDA graph, and replayed once a step.

The PyTorch counterpart of the JAX package's device epochs
(``gnn_recsys_tpu/train/minibatch.py:363-496``, steps inside ``lax.scan``
chunks): :func:`~gnn_recsys_tpu_torch.train.minibatch.make_epoch_fns` hands
:class:`CapturedStep` a body that slices one batch on the card from static
buffers (the epoch's permutation and a device step index that the body
advances), runs the step (sampling, forward, loss and, for a training step,
backward and Adam's update) and writes its loss into a device buffer.  The
capture follows PyTorch's whole-network pattern:

1. warm-up steps on a side stream, which build the kernels (``nvcc`` and
   their first-launch attributes), create Adam's state and settle the
   caching allocator; the parameters and Adam's state are put back as they
   were afterwards, and the warm-up draws come from a scratch generator;
2. one capture, with the step's ``torch.Generator`` registered with the
   graph (each replay reads the generator's current seed and offset and
   advances it, so re-seeding it between replays re-seeds the step);
3. one ``replay()`` a step.  The gradients stay in the graph's own buffers
   across replays (the step's ``zero_grad(set_to_none=True)`` runs once, at
   capture); Adam runs in its capturable form, its learning rate read from
   a device tensor that is filled from the host's schedule before each
   replay, and the host half of the update (the schedule, the count) runs
   after it.

A replay runs no Python, so the counters declared in ``utils/profiling.py``
would not see it: what the capture counted is taken off them and kept as
:attr:`CapturedStep.counts`, which each replay adds back.  For the same
reason the program's spans stay outside the captured body: a capture and its
warm-up steps run in a ``gnn.train.capture`` span, each replay (its host
part: the learning rates, the launch, Adam's host half, the counts) in a
``gnn.train.replay`` span.  A replay reads what its capture read, by address:
:meth:`CapturedStep.check` holds a call to the same objects and generator and
copies fresh inputs into the graph's buffers.  A failed capture or replay
raises; nothing falls back to the host loop.
"""

from __future__ import annotations

import warnings
from typing import Callable, Dict, List, Optional, Sequence

import torch

from gnn_recsys_tpu_torch.ops.sampling import Draws
from gnn_recsys_tpu_torch.train.full_batch import TrainState
from gnn_recsys_tpu_torch.utils.profiling import add_counts, counter_values, span

# Eager steps on a side stream before the capture.
WARMUP_STEPS = 2

# One warm-up stream a device, shared by every capture: cuBLAS gives each
# stream that runs a product its own workspace, which PyTorch keeps for the
# life of the process, so a new stream a capture would keep more device
# memory for every model a search trains.
_WARMUP_STREAMS: Dict[torch.device, torch.cuda.Stream] = {}
# One capture stream a device: ``torch.cuda.graph`` otherwise captures on one
# stream of the card that was current at its first use, and a capture on
# another card would record nothing.
_CAPTURE_STREAMS: Dict[torch.device, torch.cuda.Stream] = {}


def _warmup_stream(dev: torch.device) -> torch.cuda.Stream:
    """The side stream on which captures on ``dev`` run their warm-up."""
    if dev not in _WARMUP_STREAMS:
        _WARMUP_STREAMS[dev] = torch.cuda.Stream(dev)
    return _WARMUP_STREAMS[dev]


def _capture_stream(dev: torch.device) -> torch.cuda.Stream:
    if dev not in _CAPTURE_STREAMS:
        _CAPTURE_STREAMS[dev] = torch.cuda.Stream(dev)
    return _CAPTURE_STREAMS[dev]


class DeviceUpdate:
    """The device half of :meth:`TrainState.apply_gradients`, as a captured
    step runs it: Adam's step with each param group's learning rate read
    from a device tensor of ``lrs`` (a Python float would be frozen into the
    graph at its captured value)."""

    def __init__(self, state: TrainState, lrs: List[torch.Tensor]):
        self.tx, self.lrs = state.tx, lrs

    def apply_gradients(self) -> None:
        groups = self.tx.param_groups
        held = [g["lr"] for g in groups]
        for g, lr in zip(groups, self.lrs):
            g["lr"] = lr
        try:
            self.tx.step()
        finally:
            for g, lr in zip(groups, held):
                g["lr"] = lr


def _snapshot(state: Optional[TrainState]):
    if state is None:
        return None
    params = [p for g in state.tx.param_groups for p in g["params"]]
    opt = {p: {k: v.clone() for k, v in st.items() if torch.is_tensor(v)}
           for p, st in state.tx.state.items()}
    return params, [p.detach().clone() for p in params], opt


def _restore(state: Optional[TrainState], held) -> None:
    """Put the parameters and Adam's state back as :func:`_snapshot` found
    them; state that the warm-up created is zeroed (a fresh Adam's state is
    zeros and a count of 0, so the next update is a first one)."""
    if state is None:
        return
    params, values, opt = held
    with torch.no_grad():
        for p, v in zip(params, values):
            p.copy_(v)
        for p, st in state.tx.state.items():
            for k, v in st.items():
                if torch.is_tensor(v):
                    if k in opt.get(p, {}):
                        v.copy_(opt[p][k])
                    else:
                        v.zero_()


def take_counts(before: Dict[str, int]) -> Dict[str, int]:
    """What every counter counted since ``before`` (``counter_values()``),
    where nonzero, taken off it: a capture runs nothing, each replay adds it."""
    counts = {name: n - before.get(name, 0) for name, n in counter_values().items()
              if n != before.get(name, 0)}
    add_counts({name: -n for name, n in counts.items()})
    return counts


def _feed(buffer, value) -> None:
    """Copy ``value``'s tensors into ``buffer``'s (nested dicts) where new."""
    if isinstance(buffer, dict):
        for key, buf in buffer.items():
            _feed(buf, value[key])
    elif value is not buffer:
        buffer.copy_(value)


class CapturedStep:
    """``body(update, draws)`` captured as a CUDA graph on ``draws``'s
    generator's device.  ``body`` runs one step on static inputs: ``update``
    is a :class:`DeviceUpdate` of ``state`` for a training step (None for a
    loss-only step, ``state`` None), and ``draws`` the step's draw source.
    Capturing runs :data:`WARMUP_STEPS` eager steps first (their counts
    stand: they ran).  The step holds ``body`` and so every tensor it reads.
    :meth:`check` holds a call to ``held``, the objects that every call must
    pass again, and refreshes ``fed``, the buffers that ``body`` reads."""

    def __init__(self, body: Callable, draws: Draws, state: Optional[TrainState] = None,
                 held: Sequence = (), fed=None, warmup: int = WARMUP_STEPS):
        dev = draws.generator.device
        if dev.type != "cuda":
            raise ValueError(f"a CUDA graph needs a CUDA generator, got one on {dev}")
        self.held, self.fed = tuple(held), fed
        # The capture and its streams on the generator's card.
        with span("gnn.train.capture"), torch.cuda.device(dev):
            self._capture(body, draws, state, warmup)

    def _capture(self, body: Callable, draws: Draws, state: Optional[TrainState],
                 warmup: int) -> None:
        generator = draws.generator
        dev = generator.device
        self.state, self.generator, self.lrs = state, generator, []
        # The graph reads the tensors of ``body``'s closure by address: the
        # step keeps them alive, so a replay never reads freed memory after
        # its caller has dropped them.
        self.body = body
        update = None
        if state is not None:
            state.make_capturable()
            self.lrs = [torch.full((), float(g["lr"]), dtype=torch.float32, device=dev)
                        for g in state.tx.param_groups]
            update = DeviceUpdate(state, self.lrs)
        held = _snapshot(state)
        side = _warmup_stream(dev)
        side.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(side), warnings.catch_warnings():
            # Adam warns when its capturable form steps outside a capture.
            warnings.filterwarnings("ignore", message=".*capturable=True.*")
            scratch = Draws(torch.Generator(device=dev).manual_seed(0))
            for _ in range(warmup):
                body(update, scratch)
        torch.cuda.current_stream(dev).wait_stream(side)
        _restore(state, held)
        before = counter_values()
        self.graph = torch.cuda.CUDAGraph()
        self.graph.register_generator_state(generator)
        with torch.cuda.graph(self.graph, stream=_capture_stream(dev)):
            body(update, draws)
        torch.cuda.synchronize(dev)
        self.counts = take_counts(before)

    def check(self, held: Sequence, generator: torch.Generator, fed) -> None:
        """Raise unless ``held`` and ``generator`` are what the capture read;
        then copy ``fed`` (shaped as the step's buffers) into the buffers."""
        if any(a is not b for a, b in zip(self.held, held)):
            raise ValueError("a captured step replays on the inputs it was captured with")
        if generator is not self.generator:
            raise ValueError("a captured step replays with the generator it was captured with")
        _feed(self.fed, fed)

    def replay(self) -> None:
        """One step: the learning rates, the replay, Adam's host half, the counts."""
        with span("gnn.train.replay"):
            if self.state is not None:
                for lr, g in zip(self.lrs, self.state.tx.param_groups):
                    lr.fill_(g["lr"])
            self.graph.replay()
            if self.state is not None:
                self.state.advance()
            add_counts(self.counts)
