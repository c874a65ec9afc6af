"""The fused training superstep: K iterations a dispatch from captured CUDA
graphs (port of ``Experiment.superstep_program`` / ``_superstep_fn`` in
``t2omca_tpu/run.py:317-445``; the contract is ``docs/SPEC.md`` §8).

One dispatch runs K iterations, each rollout → ring insert
(``ReplayBuffer.insert_time_major``) → gated PER sample + QMIX train +
priority feedback, and trains bit-identically to K iterations of the
classic loop (``run.run_classic``). JAX compiles the K iterations into
one XLA program; here each iteration replays two CUDA graphs, captured
once, in one shared memory pool:

* ``rollout``: the rollout at the state's params, the time-major ring
  insert and the episode counter;
* ``train``: ``train/program.py``'s ``train_iter`` (sample → train →
  priority feedback), with every flash kernel of the learner (K1, K1 +
  residuals, K2, K3 under ``kernels.attention: pallas``).

**The state is the graphs' memory.** Each stage ends by copying the state
it computed into the tensors of the state it read (``_copy_into``):
params, target, Adam moments and count, ``train_steps``,
``last_target_update``, the ring cursor and fill, ``max_priority``, the
runner's env states, key and reward-scale state, the episode counter. The
ring's storage and priorities are written in place by the buffer itself.
That is the counterpart of JAX's ``donate=True``: the next replay reads
what the last one wrote. A state handed in with other tensors (a
checkpoint restore, a resume, a test rollout's runner state) is copied
into the bound one first (``adopt``); the returned state is always the
bound one.

**Per-call values are static device inputs** that the host fills before
each replay without a sync: the train key (a device copy of the driver's
split), the rollout's ``(T,)`` epsilons (a non-blocking copy from pinned
memory of the host schedule's values, ``ParallelRunner.epsilons``) and
PER's β (a fill with the host's float32 value,
``PrioritizedReplayBuffer.per_beta``). PER's ``n`` and the episode
counter are state tensors. The runner's ``t_env`` is a host mirror that
the program advances.

**The host decides the gate** (``docs/SPEC.md`` §8: the counters evolve
deterministically): the caller passes each sub-iteration's gate from its
host mirror and a key for each gated one. A skipped sub-iteration replays
no train graph; its info row is ``train_info_zeros`` (with the PER read
of the untouched ring under ``obs.sight``) with ``all_finite`` True, and
the driver drops it.

**Capture executes nothing.** A stage that has not run in this process
on this device runs eagerly first, through the same function: the
warm-up that loads the kernel library, cuBLAS and the autograd engine's
device thread. It is captured at its next use, from the live buffers,
so the state stays bit-exact. On a CUDA device a stage is then captured
or the call raises: there is no eager fallback. The stage functions run
eagerly otherwise only on a CPU device that the caller named, the path
the tests hold against JAX and against ``run_classic``.

``attention.LAUNCHES`` and ``dropout.LAUNCHES`` (the kernels' counts)
are counted in Python where a wrapper launches, so at capture and never
at replay. The program records each graph's launch delta at capture (and
takes it back out: capture launches nothing) and adds it at each replay,
so the counts stay "launches since reset".
Capture runs with ``capture_error_mode="thread_local"``: the watchdog,
the live plane's HTTP thread and memwatch may call the CUDA API from
their own threads meanwhile.

**Under data parallelism** (the experiment's ``comm``, a
``parallel.mesh.RankComm``) a stage holds the rank's collectives, which
a CUDA graph cannot hold under gloo (NCCL refuses two ranks on one
card). Each stage is then captured as segments (``capture_segments``):
the graph ends at each collective, which is kept and run between the
replays of its neighbours on the same static buffers (with NCCL it is
only enqueued on the stream; with gloo it is the blocking call an eager
step makes). The rollout holds none: its stats are gathered once a
dispatch, over the ``(K, B)`` stack (``ParallelRunner.gather_stats``).
The train stage holds the sample's assemble, the mask sum (ahead of the
forward: no boundary falls between a forward and its backward), the
logged values' sum, the TD errors' gather, the gradient's sum and the
priority broadcasts. The replays and collectives run the eager step's
arithmetic, so a K = 4 dispatch at N ranks equals four classic
iterations at N ranks bit for bit. ``segments`` counts a stage's graphs.

**The population** (``population.py``; JAX vmaps the same program over a
``(P,)`` axis) is :class:`PopulationProgram`: one ``SuperstepProgram`` a
member, built from the same ``Experiment``, each with its own bound state,
its own graphs, pool and CUDA stream, and its own static inputs: the
member's ``lr_scale`` and PER exponent as device scalars (filled from the
spec before each dispatch, so PBT's changes reach the replays), its
epsilon scale applied to the host epsilons it copies in, its index as the
scenario salt. A dispatch enqueues each member's K iterations on the
member's stream, after that stream waits for the caller's, and the
caller's stream then waits for every member's: the members' launch-bound
graphs overlap on the card. Each member captures on its own stream, so
cuBLAS gives each its own workspace, and into its own pool, so no two
graphs that may run at once share memory. The outputs that cross from a
member's stream to the caller's are marked with ``record_stream``.

Each call runs inside a ``torch.profiler.record_function`` range named
``superstep`` (``superstep_pop`` for a population), the program names
``obs/device_time.py`` attributes a trace's device time to.
"""

from __future__ import annotations

import ctypes
import dataclasses
import gc
import time
import warnings
from contextlib import nullcontext
from types import SimpleNamespace
from typing import Dict, List, Optional, Sequence

import torch
from torch.profiler import record_function

from .. import prng
from ..kernels import attention, dropout
from ..obs import sight
from ..utils.checkpoint import flatten_state, map_tensors
from .program import TrainState, build_train_iter

#: ``(device, stage)`` of every stage that ran eagerly in this process:
#: what the warm-up loads (the kernel library, cuBLAS, the autograd
#: engine's device thread) belongs to the process, not to one program
_WARM = set()

#: ``cuGraphNodeGetType`` values counted by ``graph_nodes``
_NODE_TYPES = {0: "kernel", 1: "memcpy", 2: "memset"}


def warm_key(device, stage: str) -> tuple:
    """The ``_WARM`` entry of ``stage`` on ``device`` (``cuda`` is the
    current card)."""
    d = torch.device(device)
    if d.type == "cuda" and d.index is None:
        d = torch.device("cuda", torch.cuda.current_device())
    return str(d), stage


def clone_state(ts: TrainState) -> TrainState:
    """A copy of ``ts`` that shares no tensor with it."""
    return map_tensors(ts, torch.clone)


def _copy_into(dst, src) -> None:
    """Write every tensor of ``src`` into the tensor at the same path of
    ``dst`` (same shapes and dtypes). A source that shares memory with a
    destination is cloned before any copy, so the order of the copies
    cannot matter."""
    d, _ = flatten_state(dst)
    s, _ = flatten_state(src)
    bad = [k for k in d if k not in s or s[k].shape != d[k].shape
           or s[k].dtype != d[k].dtype]
    if bad or len(s) != len(d):
        raise ValueError(f"superstep state mismatch at {bad[:3]} "
                         f"({len(s)} leaves into {len(d)})")
    pairs = [(d[k], s[k]) for k in d if s[k] is not d[k]]
    ptrs = {t.untyped_storage().data_ptr() for t, _ in pairs}
    pairs = [(t, v.clone() if v.untyped_storage().data_ptr() in ptrs
              else v) for t, v in pairs]
    for t, v in pairs:
        t.copy_(v)


def _new_graph():
    """→ (graph, kept): a graph that keeps its ``cudaGraph_t`` (its nodes
    can be counted, and it is instantiated by an explicit call) where
    this torch has ``keep_graph``, else one that instantiates at the end
    of its capture."""
    try:
        return torch.cuda.CUDAGraph(keep_graph=True), True
    except TypeError:
        return torch.cuda.CUDAGraph(), False


def graph_nodes(g) -> Optional[Dict[str, int]]:
    """``{"nodes", "kernel", "memcpy", "memset"}`` counts of a graph's
    nodes through the driver API, or None where the graph was not kept
    or the driver cannot be asked."""
    try:
        h = ctypes.c_void_p(int(g.raw_cuda_graph()))
        cuda = ctypes.CDLL("libcuda.so.1")
    except (AttributeError, OSError, RuntimeError, TypeError):
        return None
    get_nodes, node_type = cuda.cuGraphGetNodes, cuda.cuGraphNodeGetType
    get_nodes.argtypes = [ctypes.c_void_p, ctypes.c_void_p,
                          ctypes.POINTER(ctypes.c_size_t)]
    node_type.argtypes = [ctypes.c_void_p, ctypes.POINTER(ctypes.c_int)]
    get_nodes.restype = node_type.restype = ctypes.c_int
    n = ctypes.c_size_t(0)
    if get_nodes(h, None, ctypes.byref(n)) != 0:
        return None
    out = {"nodes": n.value, **{v: 0 for v in _NODE_TYPES.values()}}
    if not n.value:
        return out
    nodes = (ctypes.c_void_p * n.value)()
    if get_nodes(h, nodes, ctypes.byref(n)) != 0:
        return None
    kind = ctypes.c_int(0)
    for node in nodes:
        if node_type(node, ctypes.byref(kind)) == 0:
            name = _NODE_TYPES.get(kind.value)
            if name is not None:
                out[name] += 1
    return out


@dataclasses.dataclass
class Captured:
    """One captured stage: its graph, its static outputs, the kernels'
    launches a replay makes (attention and dropout-mask counts), the
    capture and instantiation seconds and the graph's node counts."""

    graph: object
    out: object
    launches: Dict[str, int]
    mask_launches: Dict[str, int]
    capture_s: float
    instantiate_s: float
    nodes: Optional[Dict[str, int]]

    def replay(self):
        """Replay the graph on the current stream, count its launches →
        its static outputs."""
        self.graph.replay()
        for kernel, n in self.launches.items():
            attention.count_launch(kernel, n)
        for kernel, n in self.mask_launches.items():
            dropout.count_launch(kernel, n)
        return self.out


def capture_graph(fn, pool, stream=None) -> Captured:
    """Capture ``fn()`` into a CUDA graph in ``pool`` on ``stream`` (torch's
    capture stream when None), under ``capture_error_mode="thread_local"``
    (other threads may call the CUDA API meanwhile). The kernels' launch
    counts move at capture, where the wrappers run: the delta is recorded
    for ``Captured.replay`` and taken back out, since capture launches
    nothing."""
    g, kept = _new_graph()
    before = dict(attention.LAUNCHES)
    before_masks = dict(dropout.LAUNCHES)
    try:
        t0 = time.perf_counter()
        with torch.cuda.graph(g, pool=pool, stream=stream,
                              capture_error_mode="thread_local"):
            out = fn()
            t1 = time.perf_counter()
        t2 = time.perf_counter()
        nodes = graph_nodes(g) if kept else None
        t3 = time.perf_counter()
        if kept:
            g.instantiate()
        t4 = time.perf_counter()
    finally:
        delta = {k: attention.LAUNCHES[k] - before[k] for k in before}
        attention.LAUNCHES.update(before)
        masks = {k: dropout.LAUNCHES[k] - before_masks[k]
                 for k in before_masks}
        dropout.LAUNCHES.update(before_masks)
    return Captured(graph=g, out=out, launches=delta, mask_launches=masks,
                    capture_s=t1 - t0, instantiate_s=(t2 - t1) + (t4 - t3),
                    nodes=nodes)


class Segments:
    """One stage captured as graphs split at its collectives
    (``capture_segments``): ``replay`` runs its steps in order on the
    current stream, each a graph or a collective (graph 0, collective 0,
    graph 1, ...; collectives with no work between them run back to
    back). The same reads as ``Captured``: the static outputs, the
    launches a replay makes (summed over the graphs), the capture and
    instantiation seconds, the node counts (summed) and ``count``, the
    number of graphs."""

    def __init__(self, steps: list, parts: List[Captured], out):
        self.steps, self.out = steps, out
        self.count = len(parts)
        self.launches = _summed([c.launches for c in parts])
        self.mask_launches = _summed([c.mask_launches for c in parts])
        self.capture_s = sum(c.capture_s for c in parts)
        self.instantiate_s = sum(c.instantiate_s for c in parts)
        nodes = [c.nodes for c in parts]
        self.nodes = (None if any(n is None for n in nodes)
                      else _summed(nodes))

    def replay(self):
        """Replay every graph with the collectives between them (the
        caller reads ``out`` and counts the launches, as for a
        ``CUDAGraph``)."""
        for step in self.steps:
            if isinstance(step, torch.cuda.CUDAGraph):
                step.replay()
            else:
                step()


def _summed(dicts) -> Dict[str, int]:
    return {k: sum(d[k] for d in dicts) for k in (dicts[0] if dicts
                                                   else ())}


def capture_segments(fn, pool, comm, stream=None) -> Segments:
    """Capture ``fn()`` as CUDA graphs in ``pool`` on ``stream`` (a new
    stream when None), split at each collective of ``comm`` (a
    ``parallel.mesh.RankComm``): the collective is not run; the graph
    being captured ends there, the call is kept, and the next graph
    begins (``parallel/mesh.py``). A graph with no work in it (two
    collectives back to back) is dropped. Nothing runs at capture. A
    capture that fails raises, and ends the graph it was in."""
    stream = stream if stream is not None else torch.cuda.Stream()
    steps: list = []
    parts: List[Captured] = []
    before = dict(attention.LAUNCHES)
    before_masks = dict(dropout.LAUNCHES)
    state = {}

    def begin():
        g, kept = _new_graph()
        state.update(g=g, kept=kept, t0=time.perf_counter(),
                     launches=dict(attention.LAUNCHES),
                     masks=dict(dropout.LAUNCHES))
        g.capture_begin(pool=pool, capture_error_mode="thread_local")

    def end(out):
        g, kept = state.pop("g"), state["kept"]
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            g.capture_end()
        t1 = time.perf_counter()
        empty = False
        for w in caught:
            if "The CUDA Graph is empty" in str(w.message):
                empty = True       # expected here (see the docstring)
            else:
                warnings.warn_explicit(w.message, w.category, w.filename,
                                       w.lineno)
        nodes = graph_nodes(g) if kept else None
        if empty or (nodes is not None and nodes["nodes"] == 0):
            return
        t2 = time.perf_counter()
        if kept:
            g.instantiate()
        t3 = time.perf_counter()
        c = Captured(
            graph=g, out=out,
            launches={k: attention.LAUNCHES[k] - state["launches"][k]
                      for k in before},
            mask_launches={k: dropout.LAUNCHES[k] - state["masks"][k]
                           for k in before_masks},
            capture_s=t1 - state["t0"], instantiate_s=t3 - t2,
            nodes=nodes)
        parts.append(c)
        steps.append(g)

    def boundary(op):
        end(None)
        steps.append(op)
        begin()

    # as torch.cuda.graph begins a capture: nothing queued, no garbage
    torch.cuda.synchronize()
    gc.collect()
    try:
        with torch.cuda.stream(stream):
            begin()
            comm.segmenter = boundary
            try:
                out = fn()
            except BaseException:
                # end the capture on its own stream, then raise
                if "g" in state:
                    try:
                        state.pop("g").capture_end()
                    except Exception:  # noqa: BLE001 — the first raises
                        pass
                raise
            finally:
                comm.segmenter = None
            end(out)
    finally:
        attention.LAUNCHES.update(before)
        dropout.LAUNCHES.update(before_masks)
    return Segments(steps, parts, out)


class SuperstepProgram:
    """``superstep(ts, keys, t_env0, gated) -> (ts', stats, infos)``: K
    iterations from ``ts`` (see the module docstring). ``keys`` is the
    ``(K, width)`` stack of train keys (rows of skipped sub-iterations are
    not read), ``t_env0`` the driver's ``t_env`` before the dispatch
    (sub-iteration ``i`` trains at ``t_env0 + (i+1)·B·T``), ``gated`` the
    K gates of the host mirror. → the bound state, the ``(K, B)``
    ``RolloutStats`` stack and the info dict of ``(K, ...)`` stacks.

    Read after a dispatch: ``consumed`` (whether the last call began to
    write the state: a failure then leaves it partly written),
    ``launches`` (each graph's attention-kernel launches a replay;
    ``mask_launches`` its dropout-mask launches), ``capture_s``
    and ``instantiate_s`` (seconds, per stage), ``nodes``
    (``graph_nodes`` per stage). With ``timing`` set on a CUDA device,
    ``events`` holds three CUDA events a sub-iteration of the last call
    (before its rollout, after it, after its train step), recorded on
    the stream with no synchronize.

    ``member`` (a population member's index) turns on the spec seams
    (``set_spec``, the module docstring); ``stream`` (a CUDA stream) is the
    stream it captures on, else torch's default capture stream. ``seat``
    (the member's index under an RngBitGenerator impl, ``prng.seat``):
    every draw is the member's rows of member 0's, as JAX's vmap of the
    members draws: the program keeps member 0's runner key (``lead``,
    filled by the population at each dispatch and advanced with each
    rollout) and takes member 0's train keys."""

    timing = False

    def __init__(self, exp, k: int, member: Optional[int] = None,
                 stream=None, seat: Optional[int] = None):
        cfg = exp.cfg
        if cfg.replay.buffer_cpu_only:
            raise ValueError(
                "superstep_program requires the device-resident replay "
                "ring; buffer_cpu_only configs use the three-program "
                "path (superstep_eligible)")
        if k < 1:
            raise ValueError(f"superstep k must be >= 1, got {k}")
        self.exp, self.k, self.device = exp, k, exp.device
        self.graphed = self.device.type == "cuda"
        self._train_iter = build_train_iter(exp.buffer, exp.learner, cfg)
        self._per = hasattr(exp.buffer, "per_beta")
        dev, t_len = self.device, cfg.env_args.episode_limit
        self._eps = torch.zeros(t_len, device=dev)
        self._key = torch.zeros(prng.IMPLS[cfg.prng_impl],
                                dtype=torch.int64, device=dev)
        self.seat, self.lead = seat, None
        if seat is not None:
            self._key = prng.seat(self._key, seat)
            self.lead = self._key.clone()
        self._beta = torch.zeros((), device=dev)
        self.member, self.stream = member, stream
        self._spec = None
        self._eps_scale = None
        self._salt = None
        if member is not None:
            self._spec = SimpleNamespace(
                lr_scale=torch.ones((), device=dev),
                per_alpha=torch.full((), float(cfg.replay.per_alpha),
                                     device=dev))
            self._eps_scale = 1.0
            if cfg.population.scenario_salt:
                # a seated member draws with member 0's salt
                self._salt = member if seat is None else 0
        self.state: Optional[TrainState] = None
        self.graphs: Dict[str, object] = {}
        self.outputs: Dict[str, object] = {}
        self.launches: Dict[str, Dict[str, int]] = {}
        self.mask_launches: Dict[str, Dict[str, int]] = {}
        self.capture_s: Dict[str, float] = {}
        self.instantiate_s: Dict[str, float] = {}
        self.nodes: Dict[str, Optional[Dict[str, int]]] = {}
        self.segments: Dict[str, int] = {}
        self.pool = None
        self.consumed = False
        self.events: List[tuple] = []

    # ------------------------------------------------------------ stages

    def _rollout(self, ts: TrainState):
        exp = self.exp
        rs, tm, stats = exp.runner.run_raw(ts.learner.params["agent"],
                                           ts.runner, eps=self._eps,
                                           member=self._salt, gather=False,
                                           lead=self.lead)
        if self.lead is not None:
            self.lead.copy_(prng.split(self.lead, 3,
                                       exp.cfg.prng_impl)[0])
        buf = exp.buffer.insert_time_major(
            ts.buffer, tm,
            alpha=None if self._spec is None else self._spec.per_alpha)
        _copy_into(ts, dataclasses.replace(
            ts, runner=rs, buffer=buf,
            episode=ts.episode + exp.cfg.batch_size_run))
        return stats

    def _train(self, ts: TrainState):
        new, info = self._train_iter(ts, self._key, 0, beta=self._beta,
                                     spec=self._spec)
        _copy_into(ts, new)
        return info

    def _run(self, name: str, fn):
        """One stage on the bound state: eagerly (a CPU device, or the
        process's warm-up of this stage) or as a replay of its graph."""
        if not self.graphed:
            return fn(self.state)
        warm = warm_key(self.device, name)
        if warm not in _WARM:
            out = fn(self.state)
            _WARM.add(warm)
            return out
        if name not in self.graphs:
            self._capture(name, fn)
        self.graphs[name].replay()
        for kernel, n in self.launches[name].items():
            attention.count_launch(kernel, n)
        for kernel, n in self.mask_launches[name].items():
            dropout.count_launch(kernel, n)
        return self.outputs[name]

    def _capture(self, name: str, fn) -> None:
        if self.pool is None:
            self.pool = torch.cuda.graph_pool_handle()
        # the capture begins with a device synchronize: wait here, so the
        # capture's seconds leave out the work queued before it (another
        # member's replays)
        torch.cuda.synchronize(self.device)
        comm = self.exp.comm
        try:
            if comm is None:
                c = capture_graph(lambda: fn(self.state), self.pool,
                                  self.stream)
            else:
                if self.stream is None:
                    self.stream = torch.cuda.Stream(self.device)
                c = capture_segments(lambda: fn(self.state), self.pool,
                                     comm, self.stream)
        except Exception as e:
            raise RuntimeError(f"superstep: capture of the {name} stage "
                               f"failed ({type(e).__name__}: {e})") from e
        self.launches[name] = c.launches
        self.mask_launches[name] = c.mask_launches
        self.capture_s[name] = c.capture_s
        self.instantiate_s[name] = c.instantiate_s
        self.nodes[name] = c.nodes
        self.segments[name] = getattr(c, "count", 1)
        self.graphs[name] = c if isinstance(c, Segments) else c.graph
        self.outputs[name] = c.out

    # ------------------------------------------------------------ driving

    def set_spec(self, lr_scale: float, eps_scale: float,
                 per_alpha: float, member: Optional[int] = None) -> None:
        """A population member's knobs for the next call: fills of its
        device scalars (on the current stream, no sync), the host epsilon
        scale and, under ``population.scenario_salt``, the scenario salt
        (the spec's ``member``; captured into the rollout graph, so it
        cannot change after the capture)."""
        if self._spec is None:
            raise ValueError("set_spec on a program built without a member")
        self._spec.lr_scale.fill_(lr_scale)
        self._spec.per_alpha.fill_(per_alpha)
        self._eps_scale = eps_scale
        if (member is not None and self._salt is not None
                and member != self._salt):
            if "rollout" in self.graphs:
                raise ValueError(f"member {self.member}: the scenario salt "
                                 f"{member} differs from the captured "
                                 f"{self._salt}")
            self._salt = member

    def adopt(self, ts: TrainState) -> TrainState:
        """Bind the program to ``ts`` (the first call), or copy ``ts``'s
        tensors and its runner's ``t_env`` (the state's one host value
        that changes) into the bound state (a restore, a resume, a test
        rollout's runner state); → the bound state."""
        if self.state is None:
            self.state = ts
        elif ts is not self.state:
            _copy_into(self.state, ts)
            self.state.runner.t_env = ts.runner.t_env
        return self.state

    def close(self) -> None:
        """Drop the graphs and their pool (the ladder's K→1 rung)."""
        self.graphs.clear()
        self.outputs.clear()
        self.pool = None
        if self.graphed:
            torch.cuda.empty_cache()

    def __call__(self, ts: TrainState, keys: torch.Tensor, t_env0: int,
                 gated: Sequence[bool]):
        with record_function("superstep"):
            return self._dispatch(ts, keys, t_env0, gated)

    def _dispatch(self, ts: TrainState, keys: torch.Tensor, t_env0: int,
                  gated: Sequence[bool]):
        """``__call__`` without its program range (a population member's
        calls sit inside the population's ``superstep_pop`` range)."""
        exp, cfg, k = self.exp, self.exp.cfg, self.k
        if len(gated) != k:
            raise ValueError(f"superstep: {len(gated)} gates for k={k}")
        self.consumed = False
        ts = self.adopt(ts)
        spr = cfg.batch_size_run * cfg.env_args.episode_limit
        eps = torch.stack([exp.runner.epsilons(ts.runner.t_env + i * spr,
                                               self._eps_scale)
                           for i in range(k)])
        if self.graphed:
            eps = eps.pin_memory()
        stats: List = []
        infos: List[dict] = []
        timing = self.timing and self.graphed
        self.events = []
        for i in range(k):
            marks = ([torch.cuda.Event(enable_timing=True)
                      for _ in range(3)] if timing else None)
            if timing:
                marks[0].record()
            self._eps.copy_(eps[i], non_blocking=True)
            self.consumed = True
            out = self._run("rollout", self._rollout)
            if timing:
                marks[1].record()
            stats.append(map_tensors(out, torch.clone))
            ts.runner.t_env += spr
            if gated[i]:
                self._key[:keys.shape[-1]].copy_(keys[i])
                if self._per:
                    self._beta.fill_(exp.buffer.per_beta(t_env0
                                                         + (i + 1) * spr))
                info = self._run("train", self._train)
                infos.append({key: v.clone() for key, v in info.items()})
            else:
                infos.append(sight.maybe_buffer_info(
                    cfg, exp.learner.train_info_zeros(cfg.batch_size),
                    ts.buffer))
            if timing:
                marks[2].record()
                self.events.append(tuple(marks))
        stacked = type(stats[0])(**{
            f.name: torch.stack([getattr(s, f.name) for s in stats])
            for f in dataclasses.fields(stats[0])})
        if exp.comm is not None:
            # the ranks' lanes, once a dispatch, outside the rollouts
            stacked = exp.runner.gather_stats(stacked)
        return ts, stacked, {key: torch.stack([i[key] for i in infos])
                             for key in infos[0]}


class PopulationProgram:
    """``pop(pts, keys, t_env0, gated, spec) -> (pts', stats, infos)``: K
    iterations of every member of a population (the module docstring).
    ``pts`` holds the P member states, ``keys`` the ``(P, K, 2)`` train
    keys (each member's stream split as the solo driver splits its one),
    ``t_env0`` and ``gated`` the one host mirror of the counters, which
    evolve identically across members, ``spec`` the ``PopulationSpec``
    whose values the members read. → the members' bound states, the ``(P,
    K, B)`` ``RolloutStats`` stack and the ``(P, K, ...)`` info stacks,
    the layout of JAX's ``population_superstep_program``.

    ``neutral`` (a one-member population with no grid, salt or PBT) builds
    its one member without the spec seams: the solo program exactly.
    ``serial=True`` runs the members one after another, each finished
    before the next starts (what P solo dispatches do), the check that the
    overlap changes no bit.

    ``members`` (global ids, all P when None) runs a subset: a
    data-parallel rank's members. Each keeps its global id for its spec
    row and scenario salt, and ``pts`` and ``keys`` then hold only those
    members, in that order; a member's dispatch is the one the whole-P
    program makes for it."""

    def __init__(self, exp, k: int, neutral: bool = False,
                 members: Optional[Sequence[int]] = None):
        p = int(exp.cfg.population.size)
        if p < 1:
            raise ValueError("population_superstep_program needs "
                             "population.size >= 1")
        if neutral and p != 1:
            raise ValueError("only a one-member population is neutral")
        self.exp, self.k, self.device = exp, k, exp.device
        self.graphed = self.device.type == "cuda"
        self.ids = list(range(p) if members is None else members)
        # under an RngBitGenerator impl JAX's vmap draws every member's
        # numbers from member 0's keys (prng.seat)
        self.seated = p > 1 and exp.cfg.prng_impl != "threefry"
        if self.seated and self.ids != list(range(p)):
            raise ValueError("a population under an RngBitGenerator impl "
                             "runs every member in one program (member 0's "
                             "keys draw for all)")
        self.members = [
            SuperstepProgram(exp, k, member=None if neutral else m,
                             stream=(torch.cuda.Stream(self.device)
                                     if self.graphed else None),
                             seat=m if self.seated else None)
            for m in self.ids]

    @property
    def consumed(self) -> bool:
        """Whether the last call began to write any member's state."""
        return any(m.consumed for m in self.members)

    @property
    def timing(self) -> bool:
        return self.members[0].timing

    @timing.setter
    def timing(self, on: bool) -> None:
        for m in self.members:
            m.timing = on

    def adopt(self, pts: Sequence[TrainState]) -> List[TrainState]:
        """Each member's ``SuperstepProgram.adopt``: → the bound states."""
        if len(pts) != len(self.members):
            raise ValueError(f"{len(pts)} member states for a population "
                             f"of {len(self.members)}")
        return [m.adopt(t) for m, t in zip(self.members, pts)]

    def close(self) -> None:
        for m in self.members:
            m.close()

    def __call__(self, pts: Sequence[TrainState], keys: torch.Tensor,
                 t_env0: int, gated: Sequence[bool], spec=None,
                 serial: bool = False):
        with record_function("superstep_pop"):
            return self._dispatch(pts, keys, t_env0, gated, spec, serial)

    def _dispatch(self, pts, keys, t_env0, gated, spec, serial):
        p = len(self.members)
        if len(pts) != p or keys.shape[0] != p:
            raise ValueError(f"population of {p}: {len(pts)} states, keys "
                             f"{tuple(keys.shape)}")
        caller = (torch.cuda.current_stream(self.device) if self.graphed
                  else None)
        if self.seated:
            # member 0's runner key as every member finds it, before any
            # member's rollout moves it (on the caller's stream)
            for prog in self.members:
                prog.lead[:4].copy_(pts[0].runner.key)
        outs = []
        for j, (prog, ts) in enumerate(zip(self.members, pts)):
            ctx = (torch.cuda.stream(prog.stream) if self.graphed
                   else nullcontext())
            with ctx:
                if self.graphed:
                    prog.stream.wait_stream(caller)
                    keys.record_stream(prog.stream)
                if spec is not None and prog.member is not None:
                    lr, eps, alpha, salt = spec.scalars(prog.member)
                    if self.seated:
                        salt = spec.scalars(0)[3]
                    prog.set_spec(lr, eps, alpha, salt)
                ts, stats, infos = prog._dispatch(
                    ts, keys[0 if self.seated else j], t_env0, gated)
                if self.graphed:
                    for t in (list(flatten_state(stats)[0].values())
                              + list(infos.values())):
                        t.record_stream(caller)
            if self.graphed and serial:
                prog.stream.synchronize()
            outs.append((ts, stats, infos))
        if self.graphed:
            for prog in self.members:
                caller.wait_stream(prog.stream)
        first = outs[0][1]
        stats = type(first)(**{
            f.name: torch.stack([getattr(o[1], f.name) for o in outs])
            for f in dataclasses.fields(first)})
        infos = {key: torch.stack([o[2][key] for o in outs])
                 for key in outs[0][2]}
        return [o[0] for o in outs], stats, infos
