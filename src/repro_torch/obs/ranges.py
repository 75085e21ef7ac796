"""Layer ranges of the port's model code, and a profiler session that
records only them.

The model code names its layers with profiler ranges (``record_function``)
that cost one check of the profiler's state when nobody profiles:

==================  ==========================================  ============
range               code                                        runs in
==================  ==========================================  ============
``embed``           ``models/common.py`` ``embed``              forward
``attn``            ``models/attention.py`` ``attn_block``,     forward,
                    ``mla_block``, ``attn_decode``              recomputation
``attn.latent``     ``mla_block``: Wkv_a, the latent's norm,    forward,
                    Wkv_b and the shared rotary key             recomputation
``mlp``             ``models/transformer.py`` ``lead_layer``'s  forward,
                    MLP (a dense lead layer of an MoE stack)    recomputation
``moe``             ``models/moe.py`` ``moe_block``             forward,
                                                                recomputation
``moe.router``,     ``_router``, ``_assign``, the repeat and    forward,
``moe.assign``,     scatter into the capacity buffer,           recomputation
``moe.dispatch``,   ``_expert_ffn``, the gather, gate and sum
``moe.experts``,    (banked and expert-parallel dispatch), the
``moe.combine``,    shared experts
``moe.shared``
``lm_loss``         ``models/transformer.py`` ``chunked_ce``    forward
``<name>.bwd``      the backward of ``embed``, ``attn``,        backward
                    ``mlp``, ``moe`` and ``lm_loss``
==================  ==========================================  ============

``train_step.grads`` and ``train_step.optimizer`` (``launch/steps.py``)
enclose them.  Under remat a group's recomputation runs inside the first
``.bwd`` range of its group, its forward ranges nested there.

:func:`span` opens a forward range.  :func:`bwd_span` marks a block's input
and output with identity autograd functions, so that the block's backward
runs inside ``<name>.bwd``: the output marker's backward opens the range,
the input marker's backward closes it, and a range whose input marker
autograd never reaches (a gradient taken only for some weights) closes when
the backward ends.  Autograd runs the backward of CUDA tensors on a thread
of its own, so these ranges are on that thread; a profiler charges a
kernel to the range open on the thread that launched it.

:func:`profile` is the operator's way to profile a training run: a session
that records the program's ranges, the CUDA runtime's launches and the
device's kernels, copies and fills, all on one clock, and none of the
operators that a default ``torch.profiler`` session records on every
thread, which stretch the steps it traces.
"""
from __future__ import annotations

import contextlib
from typing import Callable, Iterator, Tuple

import torch
from torch.autograd.profiler import record_function

# the profiler's state: true under any session, a ranges-only one included
profiling = torch._C._autograd._profiler_enabled


def span(name: str):
    """``record_function(name)`` while a profiler is on, else nothing."""
    return record_function(name) if profiling() else contextlib.nullcontext()


class _BwdRange:
    """One ``<name>.bwd`` range: opened once, closed once."""

    def __init__(self, name: str) -> None:
        self.rf = record_function(name + ".bwd")
        self.state = "new"

    def open(self) -> None:
        if self.state == "new":
            self.rf.__enter__()
            self.state = "open"
            # closes the range at the end of this backward if the input
            # marker is never reached
            torch.autograd.Variable._execution_engine.queue_callback(
                self.close)

    def close(self) -> None:
        if self.state == "open":
            self.rf.__exit__(None, None, None)
            self.state = "closed"


class _MarkOutput(torch.autograd.Function):
    @staticmethod
    def forward(ctx, y, rng):
        ctx.rng = rng
        return y.view_as(y)

    @staticmethod
    def backward(ctx, g):
        ctx.rng.open()
        return g, None


class _MarkInput(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, rng):
        ctx.rng = rng
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        ctx.rng.close()
        return g, None


def _same(y: torch.Tensor) -> torch.Tensor:
    return y


def bwd_span(name: str, x: torch.Tensor
             ) -> Tuple[torch.Tensor, Callable[[torch.Tensor], torch.Tensor]]:
    """(``x`` marked as the block's input, the function that marks its
    output): the backward from the output's mark to the input's runs inside
    the range ``<name>.bwd``.  Without a profiler, or where ``x`` takes no
    gradient, ``x`` itself and the identity: nothing enters the graph."""
    if not (profiling() and torch.is_grad_enabled() and x.requires_grad):
        return x, _same
    rng = _BwdRange(name)
    return (_MarkInput.apply(x, rng),
            lambda y: _MarkOutput.apply(y, rng))


@contextlib.contextmanager
def profile(device, path: str) -> Iterator[str]:
    """``with profile(device, path): <steps>``: a profiler session over the
    block that records the program's ranges and, on a CUDA ``device``, the
    runtime's launches and the device's work, then writes a Chrome trace to
    ``path``.  The device is synchronised on entry and exit, so the trace
    holds the block's work and only it.

    Open the trace in Perfetto or ``chrome://tracing``;
    ``perfbench/attribution.py`` charges its device and idle time to the
    ranges."""
    from torch._C._profiler import ProfilerActivity, RecordScope
    device = torch.device(device)
    cuda = device.type == "cuda"
    acts = {ProfilerActivity.CPU} | ({ProfilerActivity.CUDA} if cuda else set())
    # the configuration of a default session; only the scope differs
    cfg = torch.autograd.profiler.profile(
        use_device="cuda" if cuda else None).config
    torch._C._autograd._prepare_profiler(cfg(create_trace_id=True), acts)
    if cuda:
        torch.cuda.synchronize(device)
    torch._C._autograd._enable_profiler(cfg(), acts, {RecordScope.USER_SCOPE})
    try:
        yield path
    finally:
        if cuda:
            torch.cuda.synchronize(device)
        torch._C._autograd._disable_profiler().save(path)
