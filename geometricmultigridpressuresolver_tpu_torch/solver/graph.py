"""The CG loop on the card as a captured CUDA graph, its exit test on the device.

Port of the JAX package's `lax.while_loop` in `solver/cg.py::
solve_pcg_fused` (`cond` / `body` at :238-276 there): after the loop's
first iteration, which runs eagerly, one iteration of `solver.cg.FusedCG`
(tail + head: the V-cycle, then the CG step, x, r, ||r||^2, the count, the
history and `running`) is captured with PyTorch's CUDA graph capture and
wrapped in a conditional IF node on the device predicate `running`
(`csrc/graph.cu`: a kernel sets the node's handle from the predicate, then
the IF node runs the captured iteration as its body).  A launch after the
loop's exit runs nothing, as no body runs past `while_loop`'s exit.  The
graph is launched `REPLAYS` times back to back, then the host reads the
iteration count, `running` and ||r||^2 in one transfer; with an
`interrupt_check` it is launched once per read and the check runs after
each iteration (JAX's ordered `io_callback`, `_interrupt_flag`).

The CG step cannot write p' over p (its neighbours' p are still to be
read), so the iteration is captured twice: parity 0 reads p from one
buffer and writes p' into the other, parity 1 the reverse; the launches
alternate.  x and r are updated in place, z lives and dies inside the
iteration, so only the iterates and the 0-d scalars of the state cross
from one launch to the next.  Both parities allocate from one memory
pool, which is the solve's own: it goes back to PyTorch's caching
allocator when the solve ends (`Captured.close`).

Each solve captures once, on a side stream of its own: parity 0 while
the card runs the eager first iteration, parity 1 at its first launch,
while the card runs parity 0.  The kernels count their own launches on
the device (`ops._cuda.LaunchCounter`), so a replayed iteration counts
as an eager one does and a skipped IF body counts nothing.  A failed
capture raises; the loop never falls back to eager launches.
`mgpcg.loop_runner` sends every single-process solve on a CUDA device
here; across ranks the loop stays eager (gloo collectives cannot be
captured).

`Emulated` replays the same two parities eagerly, the IF node read on
the host, for tests without a card.

`FrameGraph` goes one level up, to the JAX package's fused frame chunk
(`lax.scan` over `_frame_traced` in `models/simulate.py::run_fused`): a
whole frame on frozen geometry, with its CG loop, is one executable graph
launched once per frame with no host read in between.  The frame is
captured in four PyTorch segments into one memory pool of its own --
everything up to the loop's first iteration (`pre`), the two parities of
one iteration, and the rest (`post`) -- split where the frame's CG solve
hands its loop to `FrameGraph.loop` (`cg.solve_pcg_fused(device_loop=)`),
and `csrc/graph.cu` (`gmg_graph_frame`) puts them together as [pre] ->
[WHILE running: parity 0, IF running: parity 1] -> [post].  The capture
is paid once per frozen geometry, as JAX pays its jit once.
`EmulatedFrame` runs the same segments eagerly, reading `running` on the
host after each iteration: the CPU, and the eager frame it is held
against on the card.
"""

from __future__ import annotations

import contextlib
import ctypes
import dataclasses
import time

import torch

from geometricmultigridpressuresolver_tpu_torch.ops import _cuda, blas, fused_smoother
from geometricmultigridpressuresolver_tpu_torch.solver import mg
from geometricmultigridpressuresolver_tpu_torch.solver.cg import FusedCG, FusedState

# K: graph launches between host reads of the loop's status (PERF.md §6
# records the sweep over 1, 4, 8 and 16 that chose it).
REPLAYS = 8


@dataclasses.dataclass
class Stats:
    """What the graph path did since the last `reset`: solves captured
    (one capture each, of both parities), graph launches, host reads of
    the loop status, the host seconds spent capturing (PyTorch's capture
    of the parities) and instantiating (wrapping each in its IF node), and
    the times a capture first returned cached memory to the card
    (`make_room`)."""

    captures: int = 0
    launches: int = 0
    reads: int = 0
    capture_seconds: float = 0.0
    instantiate_seconds: float = 0.0
    cache_releases: int = 0
    # The frame graphs (`FrameGraph`): frames captured (one per frozen
    # geometry), frame launches, host reads of a chunk's stats
    # (`models.simulate.run_fused`: one per chunk), and the host seconds
    # of their captures (the four segments) and instantiation.
    frame_captures: int = 0
    frame_launches: int = 0
    frame_reads: int = 0
    frame_capture_seconds: float = 0.0
    frame_instantiate_seconds: float = 0.0

    def reset(self) -> None:
        for f in dataclasses.fields(self):
            setattr(self, f.name, f.default)


STATS = Stats()

_STREAMS: dict[int, torch.cuda.Stream] = {}
# Bytes the last capture's memory pool took from the card, per device and
# kind ("cg": a solve's iteration, "frame": a frame).
_POOL_BYTES: dict[tuple[int, str], int] = {}


def _index(device) -> int:
    index = torch.device(device).index
    return torch.cuda.current_device() if index is None else index


def capture_stream(device: torch.device) -> torch.cuda.Stream:
    """The side stream captures run on, one per device, with cuBLAS's
    handle and workspace for it, and cuSOLVER's handle (the coarse
    inverse of a captured frame, `mg.invert`), made before any capture."""
    index = _index(device)
    if index not in _STREAMS:
        stream = torch.cuda.Stream(index)
        with torch.cuda.stream(stream), blas.ieee_products():
            a = torch.ones(8, 8, device=torch.device("cuda", index))
            torch.addmm(a[0], a, a)
            torch.matmul(a, a)
            for dtype in (torch.float32, torch.float64):
                mg.invert(torch.eye(8, dtype=dtype, device=a.device))
        stream.synchronize()
        _STREAMS[index] = stream
    return _STREAMS[index]


def make_room(device, kind: str = "cg") -> None:
    """A capture allocates only memory the card has free: PyTorch's
    caching allocator hands its cached blocks, and the pools of finished
    solves, back to the card only outside a capture.  So when the card has
    less free than the last capture of this `kind` took, hand them back
    first."""
    index = _index(device)
    need = _POOL_BYTES.get((index, kind), 0)
    if need and torch.cuda.mem_get_info(index)[0] < need:
        torch.cuda.empty_cache()
        STATS.cache_releases += 1


class Captured:
    """The two parities of one iteration, each an executable graph
    [handle = running] -> [IF handle: tail + head] on the card.  Parity 0
    is captured at once, parity 1 at its first launch: by then the card is
    running parity 0, so that capture costs the host's time alone.  Both
    allocate from one memory pool of the solve's own, which `close`
    releases."""

    def __init__(self, cg: FusedCG, s: FusedState):
        self.cg, self.s = cg, s
        self.p = (s.p, torch.empty_like(s.p))
        self.graphs, self.execs = [None, None], [None, None]
        index = _index(s.x.device)
        _cuda.device_counts(s.x.device)  # the counters' slots exist before a capture holds them
        make_room(s.x.device)
        self.pool = torch.cuda.graph_pool_handle()
        self.reserved = torch.cuda.memory_reserved(index)
        STATS.captures += 1
        self._capture(0)

    def _capture(self, parity: int) -> None:
        s, lib = self.s, _cuda.library()
        index = _index(s.x.device)
        t0 = time.perf_counter()
        with torch.cuda.stream(capture_stream(s.x.device)):
            g = torch.cuda.CUDAGraph(keep_graph=True)
            self.graphs[parity] = g  # released with the pool by `close`, captured or not
            g.capture_begin(pool=self.pool)
            try:
                s.p = self.p[parity]
                self.cg.tail(s)
                self.cg.head(s, self.p[1 - parity])
            except BaseException:
                with contextlib.suppress(RuntimeError):
                    g.capture_end()
                raise  # the first error is the one to report
            g.capture_end()
        s.z = None  # z lives in the pool; the next tail makes it again
        _POOL_BYTES[(index, "cg")] = torch.cuda.memory_reserved(index) - self.reserved
        t1 = time.perf_counter()
        handle = ctypes.c_void_p()
        _cuda.check(
            lib.gmg_graph_if(ctypes.c_void_p(g.raw_cuda_graph()), _cuda.ptr(s.running), ctypes.byref(handle)),
            "gmg_graph_if",
        )
        self.execs[parity] = handle
        STATS.capture_seconds += t1 - t0
        STATS.instantiate_seconds += time.perf_counter() - t1

    def launch(self, parity: int) -> None:
        if self.execs[parity] is None:
            self._capture(parity)
        _cuda.check(_cuda.library().gmg_graph_launch(self.execs[parity], _cuda.stream_of(self.s.x)),
                    "gmg_graph_launch")
        STATS.launches += 1

    def close(self) -> None:
        """Destroy the executable graphs and drop PyTorch's, which releases
        the solve's memory pool to the caching allocator."""
        lib = _cuda.library()
        for handle in self.execs:
            if handle is not None:
                _cuda.check(lib.gmg_graph_destroy(handle), "gmg_graph_destroy")
        self.execs = [None, None]
        self.graphs = [None, None]


class Emulated:
    """`Captured`'s launches run eagerly: tail + head into the same two p
    buffers, wherever `running` (read on the host) holds."""

    def __init__(self, cg: FusedCG, s: FusedState):
        self.cg, self.s = cg, s
        self.p = (s.p, torch.empty_like(s.p))

    def launch(self, parity: int) -> None:
        if bool(self.s.running):
            self.s.p = self.p[parity]
            self.cg.tail(self.s)
            self.cg.head(self.s, self.p[1 - parity])

    def close(self) -> None:
        pass


def run(cg: FusedCG, s: FusedState, interrupt_check=None, graphs=Captured):
    """`solver.cg.solve_pcg_fused`'s `run_loop` on the card: the loop after
    its first (eager) iteration, `REPLAYS` launches (1 with an
    `interrupt_check`) per host read; returns (iterations, ||r||^2,
    ||r|| / ||b||).  `graphs` is `Captured`, or `Emulated` on the CPU."""
    k = 1 if interrupt_check is not None else REPLAYS
    if interrupt_check is not None:
        it, running, rr, rel = cg.status(s)
        STATS.reads += 1
        if cg.interrupted(s, interrupt_check, it) or not running:
            return it, rr, rel
    loop = graphs(cg, s)
    try:
        parity = 0
        while True:
            for _ in range(k):
                loop.launch(parity)
                parity ^= 1
            it, running, rr, rel = cg.status(s)
            STATS.reads += 1
            if cg.interrupted(s, interrupt_check, it) or not running:
                return it, rr, rel
    finally:
        loop.close()


class FrameGraph:
    """One frame of the fused frame loop captured once and launched per
    frame (see the module docstring).

    `frame(loop)` runs one frame on the caller's fixed buffers: it reads
    the state they hold, hands its CG loop to `loop(cg, state)` (its
    solve's `device_loop`) and writes the next state and its stats row
    back into them; a tensor of the frame that crosses from one segment to
    the next is kept alive by the frame's own references while it is
    captured.  `prepare()` runs before the capture and fills what a
    capture must find made (transfer matrices, grids, handles); `running`
    is read off the loop's state.  A failed capture raises, after the
    segments captured so far are released; nothing falls back to eager
    launches.  `close` (also on `run_fused`'s refreeze and return)
    destroys the executable graph and drops PyTorch's, which releases the
    frame's memory pool."""

    SEGMENTS = ("pre", "it0", "it1", "post")

    def __init__(self, frame, device, prepare=None):
        self.device = torch.device(device)
        index = _index(self.device)
        _cuda.library()
        _cuda.device_counts(self.device)  # the counters' slots exist before a capture holds them
        fused_smoother.prepare_grids()
        stream = capture_stream(self.device)
        if prepare is not None:
            with torch.cuda.stream(stream):
                prepare()
            stream.synchronize()
        make_room(self.device, "frame")
        self.graphs: dict[str, torch.cuda.CUDAGraph] = {}
        self.exec = None
        self.running = None
        self._open = None
        self.pool = torch.cuda.graph_pool_handle()
        reserved = torch.cuda.memory_reserved(index)
        t0 = time.perf_counter()
        with torch.cuda.stream(stream):  # a capture ends on the stream it began on
            try:
                self._begin("pre")
                frame(self.loop)
                self._end()
                if self.running is None:
                    raise RuntimeError("the frame never handed its CG loop to FrameGraph.loop")
            except BaseException:
                if self._open is not None:
                    with contextlib.suppress(RuntimeError):
                        self.graphs[self._open].capture_end()
                self.close()
                raise  # the first error is the one to report
        _POOL_BYTES[(index, "frame")] = torch.cuda.memory_reserved(index) - reserved
        t1 = time.perf_counter()
        handle = ctypes.c_void_p()
        raw = [ctypes.c_void_p(self.graphs[k].raw_cuda_graph()) for k in self.SEGMENTS]
        try:
            _cuda.check(_cuda.library().gmg_graph_frame(*raw, _cuda.ptr(self.running), ctypes.byref(handle)),
                        "gmg_graph_frame")
        except BaseException:
            self.close()
            raise
        self.exec = handle
        STATS.frame_captures += 1
        STATS.frame_capture_seconds += t1 - t0
        STATS.frame_instantiate_seconds += time.perf_counter() - t1

    def _begin(self, name: str) -> None:
        g = torch.cuda.CUDAGraph(keep_graph=True)
        self.graphs[name] = g  # released with the pool by `close`, captured or not
        self._open = name
        g.capture_begin(pool=self.pool)

    def _end(self) -> None:
        self.graphs[self._open].capture_end()
        self._open = None

    def loop(self, cg: FusedCG, s: FusedState) -> None:
        """The frame's CG loop (its solve's `device_loop`): ends the `pre`
        segment, captures the two parities of one iteration, and begins
        `post`."""
        pair = (s.p, torch.empty_like(s.p))  # the second p buffer, in the pool
        self.running = s.running
        self._end()
        for parity in (0, 1):
            self._begin(f"it{parity}")
            s.p = pair[parity]
            cg.tail(s)
            cg.head(s, pair[1 - parity])
            self._end()
        self._begin("post")

    def launch(self) -> None:
        """One frame on the current stream."""
        _cuda.check(_cuda.library().gmg_graph_launch(self.exec, _cuda.stream_of(self.running)),
                    "gmg_graph_launch")
        STATS.frame_launches += 1

    def close(self) -> None:
        if self.exec is not None:
            _cuda.check(_cuda.library().gmg_graph_destroy(self.exec), "gmg_graph_destroy")
        self.exec = None
        self.graphs = {}
        self.running = None


class EmulatedFrame:
    """`FrameGraph`'s frames run eagerly: the same frame and the same two
    p buffers, each iteration while `running` (read on the host) holds."""

    def __init__(self, frame, device, prepare=None):
        self.frame = frame

    @staticmethod
    def loop(cg: FusedCG, s: FusedState) -> None:
        pair = (s.p, torch.empty_like(s.p))
        parity = 0
        while bool(s.running):
            s.p = pair[parity]
            cg.tail(s)
            cg.head(s, pair[1 - parity])
            parity ^= 1

    def launch(self) -> None:
        self.frame(self.loop)

    def close(self) -> None:
        pass
