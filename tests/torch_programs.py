"""The program cache (`solver/graph.py::PROGRAMS`) without a card: each
program an `EmulatedProgram`, its function run eagerly on the program's
fixed buffers at every call, so that the keys, hits, copies in and out
and the cache's eviction are the card's and the results are the eager
path's bits."""

import torch

from geometricmultigridpressuresolver_tpu_torch.solver import graph


class EmulatedProgram(graph.Program):
    """`graph.Program`'s calls run eagerly: `fn` on the same fixed buffers
    at every call (its loop through `graph.EmulatedFrame.loop`), the
    outputs copied out; `stages` counts the graphs the card would capture
    (one, and one more per `split`), and `pool_bytes` is the fixed
    buffers' bytes (the card's program adds its pool)."""

    def __init__(self, kind, fn, inputs, device, prepare=None, loop=False):
        self.kind, self.loop, self.fn = kind, loop, fn
        self.device = torch.device(device)
        self.inputs = graph._copies(inputs)
        self.outputs = None
        self.pool_bytes = graph._nbytes(graph.tensors(self.inputs))
        self.stages = 0
        graph.STATS.program_captures[kind] += 1

    def launch(self) -> None:
        self.stages = 1

        def split():
            self.stages += 1

        self.outputs = self.fn(*self.inputs, graph.EmulatedFrame.loop if self.loop else split)

    def close(self) -> None:
        self.outputs = self.inputs = self.fn = None


def emulate(monkeypatch) -> graph.Programs:
    """Entry points on CPU tensors run through a fresh program cache of
    emulated programs; the counters start at zero."""
    monkeypatch.setattr(graph, "PROGRAMS", graph.Programs())
    monkeypatch.setattr(graph, "Program", EmulatedProgram)
    monkeypatch.setattr(graph, "programs_on", lambda device: graph.PROGRAMS.enabled)
    graph.STATS.reset()
    return graph.PROGRAMS
