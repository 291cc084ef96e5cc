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

`PROGRAMS` is the counterpart of the JAX package's jit caches (`_solve`
on `_SOLVE_STATICS`, `_project_impl` on `_PROJECT_STATICS`,
`_expand_build_device`, `_device_hierarchy`, `_device_level`): a bounded
cache of `Program`s, each a function captured once as CUDA graphs over
fixed input buffers and replayed by every later call with the same key.
A key holds the function's static arguments and its inputs' structure,
shapes and dtypes (`signature`).  A call copies its inputs into the
program's buffers, replays the graphs, and returns copies of the
outputs: a later replay overwrites the program's buffers, never a result
or a setup that a caller holds (the JAX package's values).  A program
with a CG loop (`loop=True`: a solve, a projection) is captured as a
`FrameGraph`, its loop a WHILE node on the device's exit test, so a
replay reads nothing on the host.  A plain program may be cut into
stages (`split`: the per-level setup, one graph per level), all in one
memory pool.
Entries go least recently used first, when the cache is full, when a
capture needs the card's memory (`make_room`), or by `PROGRAMS.clear()`;
each takes its memory pool with it.  A program expected to take more
than half the cache's budget is not kept (`Programs.get`): its calls run
as if the cache were off.  A failed capture raises; nothing falls back
to eager launches.  `programs_on` says where the programs run: on a CUDA
device, outside a capture, while `PROGRAMS.enabled` (`programs_off()`
runs the calls as before the cache: the setup eagerly, each solve's CG
loop captured per solve by `run`).
"""

from __future__ import annotations

import collections
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
    # The program cache (`PROGRAMS`), by kind ("setup", "hierarchy",
    # "solve", "project"): programs captured, calls that replayed a cached
    # one, the host seconds of the captures (instantiation included), the
    # bytes of the captured programs' pools and fixed buffers, programs
    # evicted, and calls run uncached because their program would take
    # more than the cache keeps (`Programs.get`).
    program_captures: collections.Counter = dataclasses.field(default_factory=collections.Counter)
    program_hits: collections.Counter = dataclasses.field(default_factory=collections.Counter)
    program_capture_seconds: collections.Counter = dataclasses.field(default_factory=collections.Counter)
    program_pool_bytes: collections.Counter = dataclasses.field(default_factory=collections.Counter)
    program_evictions: collections.Counter = dataclasses.field(default_factory=collections.Counter)
    program_declined: collections.Counter = dataclasses.field(default_factory=collections.Counter)

    def reset(self) -> None:
        for f in dataclasses.fields(self):
            setattr(self, f.name, f.default_factory() if f.default is dataclasses.MISSING else f.default)


STATS = Stats()

_STREAMS: dict[int, torch.cuda.Stream] = {}
# What a capture took from the card, per device and kind ("cg": a solve's
# iteration, "frame": a frame, the last capture; a program's kind, its
# largest capture so far): (its size, bytes taken).  A program's size is
# what its memory grows with (`call`'s `size`).
_POOL_BYTES: dict[tuple[int, str], tuple[int, int]] = {}


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


def _record(device, kind: str, taken: int, size: int = 0) -> None:
    key = (_index(device), kind)
    if size >= _POOL_BYTES.get(key, (0, 0))[0]:
        _POOL_BYTES[key] = (size, taken)


def expected_bytes(device, kind: str, size: int = 0) -> float:
    """What a capture of `kind` is expected to take from the card: the
    recorded capture's bytes, scaled by `size` where the record has its
    own (a program's pool and buffers grow with its size)."""
    device = torch.device(device)
    if device.type != "cuda":
        return 0
    rec_size, taken = _POOL_BYTES.get((_index(device), kind), (0, 0))
    return taken * size / rec_size if rec_size and size else taken


def make_room(device, kind: str = "cg", size: int = 0) -> bool:
    """A capture allocates only memory the card has free: PyTorch's
    caching allocator hands its cached blocks, and the pools of finished
    solves and evicted programs, back to the card only outside a capture.
    So when the card has less free than `expected_bytes`, hand them back
    first.  Whether the card then has that much free."""
    need = expected_bytes(device, kind, size)
    if not need:
        return True
    index = _index(device)
    if torch.cuda.mem_get_info(index)[0] >= need:
        return True
    torch.cuda.empty_cache()
    STATS.cache_releases += 1
    return torch.cuda.mem_get_info(index)[0] >= need


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
        _record(s.x.device, "cg", torch.cuda.memory_reserved(index) - self.reserved)
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
    frame's memory pool.  `counted=False` (a program of `PROGRAMS`, which
    makes its own room and counts its own) leaves `make_room`, the pool's
    size record and `STATS.frame_*` alone."""

    SEGMENTS = ("pre", "it0", "it1", "post")

    def __init__(self, frame, device, prepare=None, counted: bool = True):
        self.counted = counted
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
        if counted:
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
        if counted:
            _record(self.device, "frame", torch.cuda.memory_reserved(index) - reserved)
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
        if counted:
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
        if self.counted:
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

    def __init__(self, frame, device, prepare=None, counted: bool = True):
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


# ---- the program cache ------------------------------------------------------


def tree_map(fn, tree, leaf=torch.Tensor):
    """`tree` with each leaf of type `leaf` (a tensor) replaced by
    fn(leaf): tuples, lists, NamedTuples and dicts are walked, any other
    leaf is kept."""
    if isinstance(tree, leaf):
        return fn(tree)
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(tree_map(fn, x, leaf) for x in tree))
    if isinstance(tree, (tuple, list)):
        return type(tree)(tree_map(fn, x, leaf) for x in tree)
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, leaf) for k, v in tree.items()}
    return tree


def tensors(tree) -> list[torch.Tensor]:
    """The distinct tensor leaves of `tree`, in order of first appearance."""
    seen: dict[int, torch.Tensor] = {}

    def visit(t):
        seen.setdefault(id(t), t)
        return t

    tree_map(visit, tree)
    return list(seen.values())


def signature(tree):
    """A hashable description of `tree`: its structure and other leaves,
    each tensor's shape, dtype, device and strides, and which leaves are
    one tensor (the index of its first appearance)."""
    seen: dict[int, int] = {}

    def sig(x):
        if isinstance(x, torch.Tensor):
            return ("tensor", tuple(x.shape), x.dtype, x.device, x.stride(), seen.setdefault(id(x), len(seen)))
        if isinstance(x, (tuple, list)):
            return (type(x).__name__,) + tuple(sig(v) for v in x)
        if isinstance(x, dict):
            return ("dict",) + tuple((k, sig(v)) for k, v in sorted(x.items()))
        return x

    return sig(tree)


def _copies(tree):
    """Fresh tensors like `tree`'s (one per distinct tensor, so aliasing
    is kept)."""
    memo: dict[int, torch.Tensor] = {}

    def copy(t):
        if id(t) not in memo:
            memo[id(t)] = torch.empty_strided(t.shape, t.stride(), dtype=t.dtype, device=t.device)
        return memo[id(t)]

    return tree_map(copy, tree)


def _clone(tree):
    memo: dict[int, torch.Tensor] = {}

    def clone(t):
        if id(t) not in memo:
            memo[id(t)] = t.clone()
        return memo[id(t)]

    return tree_map(clone, tree)


def _nbytes(ts) -> int:
    return sum(t.numel() * t.element_size() for t in ts)


class Program:
    """`fn(*inputs, split)` captured once on the card over fixed input
    buffers (`inputs` is a tree of tensors and static leaves: `tree_map`'s)
    and replayed by each call.  Plain: CUDA graphs captured on the side
    stream into one memory pool of the program's own, one graph per stage:
    `split()` ends the graph being captured and begins the next (the
    per-level setup, one graph per level, as JAX compiles one program
    per level); the stages replay in order, and a stage's workspace is
    free for the next one's.  `loop=True`: `fn(*inputs, device_loop)`
    hands its CG loop to `device_loop` (`cg.solve_pcg_fused(device_loop=)`)
    and is captured as a `FrameGraph`, [pre] -> [WHILE running: the two
    parities] -> [post].  `prepare()` runs first, on the capture stream
    (what a capture must find made).  Calling the program copies the
    inputs into the fixed buffers, launches the graphs on the current
    stream and returns copies of its outputs.  `close` releases the
    graphs and their pool.  `transient`: the cache did not keep it."""

    transient = False

    def __init__(self, kind: str, fn, inputs, device, prepare=None, loop: bool = False):
        self.kind, self.loop = kind, loop
        self.device = torch.device(device)
        self.inputs = _copies(inputs)
        t0 = time.perf_counter()
        self.graphs: list[torch.cuda.CUDAGraph] = []
        self.frame = None
        if loop:
            out = []
            self.frame = FrameGraph(lambda device_loop: out.append(fn(*self.inputs, device_loop)),
                                    self.device, prepare, counted=False)
            self.outputs, pool = out[0], self.frame.pool
        else:
            stream = capture_stream(self.device)
            if prepare is not None:
                with torch.cuda.stream(stream):
                    prepare()
            stream.synchronize()
            pool = torch.cuda.graph_pool_handle()

            def begin():
                self.graphs.append(torch.cuda.CUDAGraph())
                self.graphs[-1].capture_begin(pool=pool)

            def split():
                self.graphs[-1].capture_end()
                begin()

            with torch.cuda.stream(stream):  # a capture ends on the stream it began on
                begin()
                try:
                    self.outputs = fn(*self.inputs, split)
                except BaseException:
                    with contextlib.suppress(RuntimeError):
                        self.graphs[-1].capture_end()
                    self.graphs = []
                    raise  # the first error is the one to report
                self.graphs[-1].capture_end()
        pool = tuple(pool)
        segments = torch.cuda.memory_snapshot()
        self.pool_bytes = sum(seg["total_size"] for seg in segments if tuple(seg["segment_pool_id"]) == pool)
        self.pool_bytes += _nbytes(tensors(self.inputs))
        STATS.program_captures[kind] += 1
        STATS.program_capture_seconds[kind] += time.perf_counter() - t0
        STATS.program_pool_bytes[kind] += self.pool_bytes

    def _copy_in(self, inputs) -> None:
        for dst, src in zip(tensors(self.inputs), tensors(inputs)):
            dst.copy_(src)

    def launch(self) -> None:
        if self.loop:
            self.frame.launch()
        for g in self.graphs:
            g.replay()

    def __call__(self, *inputs):
        self._copy_in(inputs)
        self.launch()
        return _clone(self.outputs)

    def close(self) -> None:
        if self.frame is not None:
            self.frame.close()
        self.graphs, self.frame = [], None
        self.outputs = self.inputs = None


def no_split() -> None:
    """A program's `split` where it runs uncaptured: its stages run on."""


class Programs:
    """The program cache: `Program`s by key, least recently used first
    out.  At most `capacity` entries, holding at most `budget` of the
    card's memory: before a capture, entries go until the card has what
    the capture is expected to take (`make_room`); after it, until the
    entries hold at most the budget.  The budget leaves three quarters of
    the card to the work that runs outside the programs: the pools hold
    their memory between calls, and an eager allocation cannot evict them
    (PERF.md section 7).  A program expected to take more than half the
    budget is not kept: the setup and the projection of one frame must fit
    together, or each frame's capture would evict the other's program and
    every frame would capture both again."""

    def __init__(self, capacity: int = 32, budget: float = 0.25):
        self.capacity, self.budget = capacity, budget
        self.enabled = True
        self.entries: collections.OrderedDict = collections.OrderedDict()
        self.declined: set = set()

    def __len__(self) -> int:
        return len(self.entries)

    def held_bytes(self) -> int:
        """Bytes of the cached programs' pools and fixed buffers."""
        return sum(p.pool_bytes for p in self.entries.values())

    def budget_bytes(self, device) -> float:
        device = torch.device(device)
        if device.type != "cuda":
            return float("inf")
        return self.budget * torch.cuda.get_device_properties(device).total_memory

    def get(self, kind: str, key, make, device, size: int) -> Program | None:
        """The program of (`kind`, `key`): the cached one, or `make()`'s (a
        capture of `size` on `device`, `call`'s) after making room; None
        where the program is expected to take more than half the budget
        (`expected_bytes`).  A capture that takes more than that is not
        kept (`Program.transient`: the caller closes it after its call),
        and its key is not captured again."""
        full = (kind,) + tuple(key)
        prog = self.entries.get(full)
        if prog is not None:
            self.entries.move_to_end(full)
            STATS.program_hits[kind] += 1
            return prog
        limit = self.budget_bytes(device) / 2
        if full in self.declined or expected_bytes(device, kind, size) > limit:
            self.declined.add(full)
            STATS.program_declined[kind] += 1
            return None
        while len(self.entries) >= self.capacity:
            self._evict_oldest()
        while not make_room(device, kind, size) and self.entries:
            self._evict_oldest()
        prog = make()
        if prog.device.type == "cuda":
            _record(prog.device, kind, prog.pool_bytes, size)
        if prog.pool_bytes > limit:
            self.declined.add(full)
            prog.transient = True
            return prog
        self.entries[full] = prog
        while self.held_bytes() > 2 * limit and next(iter(self.entries)) != full:
            self._evict_oldest()
        return prog

    def _evict_oldest(self) -> None:
        full = next(iter(self.entries))
        STATS.program_evictions[full[0]] += 1
        self.entries.pop(full).close()

    def clear(self) -> None:
        """Drop every program (its graphs, fixed buffers and pool) and
        forget the declined keys."""
        while self.entries:
            self.entries.popitem(last=False)[1].close()
        self.declined.clear()


PROGRAMS = Programs()


def programs_on(device) -> bool:
    """Whether calls on `device` run as cached programs: a CUDA device,
    outside a capture (a program inside a captured frame is that frame's),
    with the cache enabled.  Elsewhere they run as before: the setup
    eagerly, a solve's CG loop captured per solve (`run`)."""
    return (
        PROGRAMS.enabled
        and torch.device(device).type == "cuda"
        and not torch.cuda.is_current_stream_capturing()
    )


@contextlib.contextmanager
def programs_off():
    """Inside the block no call runs as a cached program (`programs_on`)."""
    saved = PROGRAMS.enabled
    PROGRAMS.enabled = False
    try:
        yield
    finally:
        PROGRAMS.enabled = saved


def call(kind: str, key, fn, inputs, device, prepare=None, loop: bool = False, uncached=None, size=None):
    """`fn(*inputs, split)` (`fn(*inputs, device_loop)` when `loop`) as the
    cached program of `kind` for `key` and the inputs' `signature` on
    `device`: captured on a miss, replayed on a hit; returns copies of its
    outputs.  `key` must hold everything `fn` reads besides its
    arguments.  Where the cache does not keep the program (`Programs.get`)
    the call runs as with the cache off: `uncached()`, or `fn` on
    `inputs` uncaptured (`no_split`) or with its CG loop captured per
    solve (`device_loop` None).  `size` is what the program's memory
    grows with, for `expected_bytes` (default: the inputs' bytes)."""
    device = torch.device(device)
    index = _index(device) if device.type == "cuda" else -1
    full = (index, signature(inputs)) + tuple(key)
    size = _nbytes(tensors(inputs)) if size is None else size
    prog = PROGRAMS.get(kind, full, lambda: Program(kind, fn, inputs, device, prepare, loop), device, size)
    if prog is None:
        return uncached() if uncached is not None else fn(*inputs, None if loop else no_split)
    try:
        return prog(*inputs)
    finally:
        if prog.transient:
            prog.close()
