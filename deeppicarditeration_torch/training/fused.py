"""A training body captured once as a CUDA graph and replayed.

Counterpart of the JAX package's fused dispatches: the fit and its evals in
one ``lax.scan`` (``training/picard.py:_make_fused_freq_scan``,
``_run_fused_freq``) and each log interval of a baseline in one
(``training/baselines.py:_baseline_loop``). Here the body is a Python
callable: an epoch of train steps and its evals, one D-DBSDE epoch or one
DBDP sub-iteration. It reads static input buffers, which the caller
refills eagerly before each call (the shuffle, the eval points), and may
draw inside: from ``generators`` that the caller seeds before each call
(registered with the graph, so that a replay draws from the seed they
hold then) and from the rollout kernel with a ``kernels.SeedTable``
(advanced inside the graph). It returns tensors that the caller reads
after it.

On the card the first call warms the body up on a side stream (cuBLAS
handles, Adam's foreach buffers), captures it with ``torch.cuda.graph``
and restores the parameters, the optimizer state, the ``state`` tensors
(a seed table's index) and the generators from a snapshot taken before
the warm-up, so that the warm-up leaves no trace in the trajectory; every
call replays the graph. The port's kernels count only the warm-up's
launches (``kernels.CudaLibrary.count``): the capture records them and a
replay runs no wrapper. The returned tensors live in the graph's memory
and are overwritten by the next replay. The graph holds the
addresses of the parameters, the optimizer state and the buffers: the
caller keeps all of them alive and updates them in place only. A capture
that fails raises; nothing falls back to running the body eagerly.

On the CPU every call runs the body eagerly: the path the CPU tests hold
against the loop.
"""

from __future__ import annotations

from typing import Callable, Dict, Sequence

import torch

# Warm-up calls of the body before its capture (PyTorch's whole-network
# capture example takes 3; the state the body needs exists after one).
WARMUP = 2


class FusedStep:
    """``body()`` over the static buffers ``inputs``; captured on the card
    at the first call, then replayed."""

    def __init__(self, body: Callable[[], object],
                 inputs: Dict[str, torch.Tensor], module: torch.nn.Module,
                 optimizer: torch.optim.Optimizer,
                 generators: Sequence[torch.Generator] = (),
                 state: Sequence[torch.Tensor] = ()):
        self.body = body
        self.inputs = inputs
        self.module = module
        self.optimizer = optimizer
        self.generators = tuple(generators)
        self.extra_state = tuple(state)
        self.device = next(module.parameters()).device
        self.graph = None
        self.outputs = None
        self.replays = 0

    def __call__(self):
        if self.device.type != "cuda":
            return self.body()
        if self.graph is None:
            self._capture()
        self.graph.replay()
        self.replays += 1
        return self.outputs

    def _state(self):
        """Every tensor the warm-up changes: parameters, buffers, and the
        optimizer's state (which must exist already: ``reset_optimizer``)."""
        tensors = list(self.module.parameters()) + list(self.module.buffers())
        for group in self.optimizer.param_groups:
            for p in group["params"]:
                state = self.optimizer.state[p]
                if not state:
                    raise RuntimeError(
                        "the optimizer state must exist before the capture "
                        "(trainer.reset_optimizer creates it)")
                tensors += [v for v in state.values() if torch.is_tensor(v)]
        return tensors + list(self.extra_state)

    def _capture(self):
        state = self._state()
        with torch.no_grad():
            snapshot = [t.detach().clone() for t in state]
        gen_states = [g.get_state() for g in self.generators]
        side = torch.cuda.Stream(self.device)
        side.wait_stream(torch.cuda.current_stream(self.device))
        with torch.cuda.stream(side):
            for _ in range(WARMUP):
                self.body()
        torch.cuda.current_stream(self.device).wait_stream(side)
        self.optimizer.zero_grad(set_to_none=True)
        graph = torch.cuda.CUDAGraph()
        for g in self.generators:
            graph.register_generator_state(g)
        with torch.cuda.graph(graph):
            outputs = self.body()
        with torch.no_grad():
            for t, s in zip(state, snapshot):
                t.copy_(s)
        for g, st in zip(self.generators, gen_states):
            g.set_state(st)
        self.graph, self.outputs = graph, outputs
