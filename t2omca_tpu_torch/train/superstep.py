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
import time
from contextlib import nullcontext
from types import SimpleNamespace
from typing import Dict, List, Optional, Sequence

import torch
from torch.profiler import record_function

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
    nodes = (ctypes.c_void_p * n.value)()
    if get_nodes(h, nodes, ctypes.byref(n)) != 0:
        return None
    out = {"nodes": n.value, **{v: 0 for v in _NODE_TYPES.values()}}
    kind = ctypes.c_int(0)
    for node in nodes:
        if node_type(node, ctypes.byref(kind)) == 0:
            name = _NODE_TYPES.get(kind.value)
            if name is not None:
                out[name] += 1
    return out


class SuperstepProgram:
    """``superstep(ts, keys, t_env0, gated) -> (ts', stats, infos)``: K
    iterations from ``ts`` (see the module docstring). ``keys`` is the
    ``(K, 2)`` stack of train keys (rows of skipped sub-iterations are
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
    stream it captures on, else torch's default capture stream."""

    timing = False

    def __init__(self, exp, k: int, member: Optional[int] = None,
                 stream=None):
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
        self._key = torch.zeros(2, dtype=torch.int64, device=dev)
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
                self._salt = member
        self.state: Optional[TrainState] = None
        self.graphs: Dict[str, object] = {}
        self.outputs: Dict[str, object] = {}
        self.launches: Dict[str, Dict[str, int]] = {}
        self.mask_launches: Dict[str, Dict[str, int]] = {}
        self.capture_s: Dict[str, float] = {}
        self.instantiate_s: Dict[str, float] = {}
        self.nodes: Dict[str, Optional[Dict[str, int]]] = {}
        self.pool = None
        self.consumed = False
        self.events: List[tuple] = []

    # ------------------------------------------------------------ stages

    def _rollout(self, ts: TrainState):
        exp = self.exp
        rs, tm, stats = exp.runner.run_raw(ts.learner.params["agent"],
                                           ts.runner, eps=self._eps,
                                           member=self._salt)
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
        warm = (str(self.device), name)
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
        g, kept = _new_graph()
        before = dict(attention.LAUNCHES)
        before_masks = dict(dropout.LAUNCHES)
        # the capture begins with a device synchronize: wait here, so the
        # capture's seconds leave out the work queued before it (another
        # member's replays)
        torch.cuda.synchronize(self.device)
        try:
            t0 = time.perf_counter()
            with torch.cuda.graph(g, pool=self.pool, stream=self.stream,
                                  capture_error_mode="thread_local"):
                out = fn(self.state)
                t1 = time.perf_counter()
            t2 = time.perf_counter()
            self.nodes[name] = graph_nodes(g) if kept else None
            t3 = time.perf_counter()
            if kept:
                g.instantiate()
            t4 = time.perf_counter()
        except Exception as e:
            raise RuntimeError(f"superstep: capture of the {name} stage "
                               f"failed ({type(e).__name__}: {e})") from e
        finally:
            delta = {k: attention.LAUNCHES[k] - before[k] for k in before}
            attention.LAUNCHES.update(before)
            masks = {k: dropout.LAUNCHES[k] - before_masks[k]
                     for k in before_masks}
            dropout.LAUNCHES.update(before_masks)
        self.launches[name] = delta
        self.mask_launches[name] = masks
        self.capture_s[name] = t1 - t0
        self.instantiate_s[name] = (t2 - t1) + (t4 - t3)
        self.graphs[name], self.outputs[name] = g, out

    # ------------------------------------------------------------ driving

    def set_spec(self, lr_scale: float, eps_scale: float,
                 per_alpha: float) -> None:
        """A population member's knobs for the next call: fills of its
        device scalars (on the current stream, no sync) and the host
        epsilon scale."""
        if self._spec is None:
            raise ValueError("set_spec on a program built without a member")
        self._spec.lr_scale.fill_(lr_scale)
        self._spec.per_alpha.fill_(per_alpha)
        self._eps_scale = eps_scale

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
                self._key.copy_(keys[i])
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
    overlap changes no bit."""

    def __init__(self, exp, k: int, neutral: bool = False):
        p = int(exp.cfg.population.size)
        if p < 1:
            raise ValueError("population_superstep_program needs "
                             "population.size >= 1")
        if neutral and p != 1:
            raise ValueError("only a one-member population is neutral")
        self.exp, self.k, self.device = exp, k, exp.device
        self.graphed = self.device.type == "cuda"
        self.members = [
            SuperstepProgram(exp, k, member=None if neutral else m,
                             stream=(torch.cuda.Stream(self.device)
                                     if self.graphed else None))
            for m in range(p)]

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
        outs = []
        for m, (prog, ts) in enumerate(zip(self.members, pts)):
            ctx = (torch.cuda.stream(prog.stream) if self.graphed
                   else nullcontext())
            with ctx:
                if self.graphed:
                    prog.stream.wait_stream(caller)
                    keys.record_stream(prog.stream)
                if spec is not None and prog.member is not None:
                    prog.set_spec(*spec.scalars(m))
                ts, stats, infos = prog._dispatch(ts, keys[m], t_env0,
                                                  gated)
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
