"""Sebulba's decoupled actor/learner machinery (port of
``t2omca_tpu/parallel/sebulba.py``; the driver loop is ``run.run_sebulba``).

Podracer's Sebulba split (PAPERS.md, arXiv 2104.06272) runs the rollout
and the training on disjoint device sets with a bounded trajectory queue
between them, so neither phase idles the other's devices. In the port a
device set is a tuple of placements (``mesh.partition_devices``): a
device and the CUDA stream its work is enqueued on. With enough cards
each placement is a card; under ``--share-cards`` each is a stream of
card 0, and the overlap is the streams'; on the CPU every placement is
the CPU, with no stream.

Pieces:

* an actor set of n placements runs n lane shards: shard r steps the
  global lanes ``r, r + n, ...`` and draws its rows of every global draw
  (``LaneShard``, the data-parallel rank layout of
  ``runners/parallel_runner.py``), with no collective: the actor thread
  merges the shards' time-major emissions in global lane order into the
  learner's queue slot, and their stats the same way;
* :class:`LearnerSideState`: the learner half of the ``TrainState`` (the
  learner, the ring, the episode counter) on a learner placement; the
  runner state is the actor half, split over the shards;
* :class:`QueueState`: ``queue_slots`` slots on a learner placement, each
  one rollout batch (that placement's lanes of it) in the rollout's
  time-major emission form (``TimeMajorEpisodes``), never the assembled
  episode batch;
* :class:`LearnerSeat`: one placement of the learner set, with its
  learner, ring, queue slots, static inputs and graphs;
* :class:`Sebulba`: the placements, the bound states, the four programs
  (``actor_step``, ``queue_put``, ``queue_get``, ``learner_step``) and
  the learner→actor parameter publish;
* :class:`PopulationSebulba` (a population, lockstep only): one
  ``Sebulba`` a member with the member's spec seams, the members split
  over the actor placements and over the learner placements by
  ``mesh.member_blocks`` (each member's lanes whole on one actor
  placement, its learner whole on one learner placement).

**A learner set of n placements** (JAX's learner mesh, over which GSPMD
shards the ring's episodes, replicates the params and PER's bookkeeping
and sums the gradients) is the data-parallel layout of
``parallel/mesh.py`` inside one process: placement r holds the learner
state, the counters and the priorities whole, and the ring slots ``r, r
+ n, ...`` (``mesh.lane_rows``, a dp rank's rows), and its learner and
ring take the placement's ``PlacementComm`` as their ``comm``, exactly
as they take a rank's. Placement r's queue slots hold the lanes ``r::n``
of each batch, the lanes its insert writes; where n does not divide the
lane count, an insert's lanes land on the placements by the cursor, so
every placement's slots hold every lane and its insert picks its own
(``ReplayBuffer.own_lanes``). A learner step runs every
placement's train stage at once, one thread a placement
(``PlacementGroup.run``): a learner step's replay blocks the thread
that launches it for about its device time (~972 ms at T = 150 on an
H100, ``PERF.md`` §5), so one thread replaying the placements in turn
would run them one after another. On the card each placement's train stage is
captured as segments split at its collectives
(``train/superstep.capture_segments``), and a replay runs the
collectives between the graphs. ``publish`` reads placement 0's params;
``join`` first checks that the placements' replicated leaves agree, and
gathers the ring rows back into the one-card layout, so a checkpoint
resumes under the classic loop, under dp and at any learner-set size.

**The states are the programs' memory**, as in ``train/superstep.py``:
each shard's runner state, the learner-side state, the queue slots, the
published parameter snapshots and each shard's acting parameters are
bound tensors that every program writes in place (JAX threads donated
buffers instead). ``place`` copies a state handed in (a resume, a
restore) into them; ``join`` reassembles the checkpointable
``TrainState``.

**On a CUDA device the programs are captured CUDA graphs**
(``train/superstep.capture_graph``): each shard's rollout on its stream
in its own pool, and on the learner stream, in the learner's pool, one
``queue_get`` + ring insert a slot and the learner step. ``capture``
makes them all in the calling thread before the driver starts its actor
thread (so no capture ever runs while another thread enqueues work):
each kind of stage first runs once eagerly on a clone of the state (the
process's warm-up: the kernel library, cuBLAS, the autograd engine), and
the captures, which execute nothing, leave the state as it was. On the
CPU the same stage functions run eagerly.

**JAX's dataflow ordering is rebuilt from CUDA events**, recorded and
waited outside every graph:

* a slot's put waits on the event of that slot's last get (the actor
  never overwrites a batch the learner still reads), and a get waits on
  the put events of its slot's shards;
* the learner's publish copies the agent params (placement 0's) into
  one of two snapshots on its stream after that stream waited on every
  shard's last adopt of that snapshot, then records an event; a shard's
  adopt waits on that event and copies the snapshot into the rollout
  graph's static params on its own stream, then records its adopt event.
  The host side of both runs under the driver's condition lock, so the
  event each side waits on is the one the other recorded last. On
  separate cards the same copies are peer copies.

``AUDIT`` (None on the main path) is the race check's hook: set to an
:class:`Audit`, the programs record device digests of every emission at
its put and of its ring rows after its get, of every publish and every
adopt, and each training rollout's params version; ``Audit.check``
then holds them against each other (``chip_smoke.py``'s ``[sebulba]``).
"""

from __future__ import annotations

import dataclasses
import threading
from contextlib import nullcontext
from types import SimpleNamespace
from typing import List, Optional, Sequence, Tuple

import torch
from torch.profiler import record_function

from ..components.episode_buffer import (BufferState, TimeMajorEpisodes,
                                         obs_map)
from .. import prng
from ..kernels import attention, dropout
from ..train.program import TrainState, build_train_iter
from ..train.superstep import (_WARM, Segments, _copy_into, capture_graph,
                               capture_segments, clone_state, warm_key)
from ..utils.checkpoint import _rebuild, flatten_state, map_tensors
from .mesh import (Placement, PlacementGroup, interleave_rows, lane_rows,
                   lane_sharded, member_blocks, partition_devices,
                   replicated_digest)

#: the race check's recorder (module docstring); None on the main path
AUDIT = None

#: the time-major leaves (batch axis 1); the rest, the bootstrap step,
#: carry the batch on axis 0
_SEQ_FIELDS = ("obs", "state", "avail_actions", "actions", "reward",
               "terminated")


@dataclasses.dataclass
class LearnerSideState:
    """The learner placement's half of ``TrainState``: what the learner
    thread's programs carry."""

    learner: object               # LearnerState
    buffer: BufferState
    episode: torch.Tensor         # () int32: episodes consumed into the ring


@dataclasses.dataclass
class QueueState:
    """``queue_slots`` trajectory slots on the learner placement, each a
    ``TimeMajorEpisodes`` at the global lane count. Which slots hold live
    batches is the driver's host-side bookkeeping (its put/get counters);
    the slots are storage."""

    slots: List[TimeMajorEpisodes]


@dataclasses.dataclass(frozen=True)
class LaneShard:
    """Shard ``rank`` of ``world`` of the actor set, in the runner's
    ``comm`` seat: the lanes ``rank, rank + world, ...`` and the rows of
    every global draw. It has no collective: ``gather_lanes`` returns the
    shard's own lanes, which the actor thread merges itself."""

    rank: int
    world: int

    def gather_lanes(self, t: torch.Tensor, dim: int = 0) -> torch.Tensor:
        return t


def tm_map(fn, tm: TimeMajorEpisodes, *others) -> TimeMajorEpisodes:
    """``fn(leaf, *other leaves, batch_axis)`` over every leaf of a
    ``TimeMajorEpisodes`` (compact obs leaves included)."""
    out = {}
    for f in dataclasses.fields(TimeMajorEpisodes):
        axis = 1 if f.name in _SEQ_FIELDS else 0
        out[f.name] = obs_map(lambda x, *o, a=axis: fn(x, *o, a),
                              getattr(tm, f.name),
                              *(getattr(o, f.name) for o in others))
    return TimeMajorEpisodes(**out)


def tm_leaves(tm: TimeMajorEpisodes) -> List[torch.Tensor]:
    leaves = []
    tm_map(lambda x, _a: leaves.append(x) or x, tm)
    return leaves


def digest(tensors: Sequence[torch.Tensor]) -> torch.Tensor:
    """A device digest of tensors' bytes that ignores their order and
    layout: the sum and the sum of squares of every byte, as a ``(2,)``
    int64 tensor (no host sync)."""
    total = None
    for x in tensors:
        b = x.detach().contiguous().reshape(-1).view(torch.uint8).long()
        d = torch.stack([b.sum(), (b * b).sum()])
        total = d if total is None else total + d.to(total.device)
    return total


class Audit:
    """The race check's records (module docstring). Every digest is a
    device tensor on the stream that computed it until ``check`` reads
    them, after the run (a put's is one a shard)."""

    def __init__(self):
        self.lock = threading.Lock()
        self.puts, self.gets = {}, {}       # put index -> digests
        self.publishes = {}                 # version -> digest
        self.replicas = {}                  # version -> placements' digests
        self.adopts = []                    # (rollout, shard, version, digest)
        self.rollouts = []                  # (rollout index, version)
        self.members = {}                   # population member -> Audit

    def member(self, m: int) -> "Audit":
        """The records of population member ``m`` (each member's queue and
        params are its own)."""
        with self.lock:
            return self.members.setdefault(m, Audit())

    def check(self, staleness: int) -> dict:
        """Hold every record against its counterpart; raises naming the
        first failure. → the counts checked (summed over the members of a
        population; ``replicas`` where a learner set recorded them)."""
        if self.members:
            counts = [a.check(staleness) for a in self.members.values()]
            return {k: sum(c[k] for c in counts) for k in counts[0]}
        with self.lock:
            every = ([d for ps in self.puts.values() for d in ps]
                     + [d for gs in self.gets.values() for d in gs]
                     + [d for rs in self.replicas.values() for d in rs]
                     + list(self.publishes.values())
                     + [a[3] for a in self.adopts])
            for dev in {d.device for d in every if d.is_cuda}:
                torch.cuda.synchronize(dev)     # every stream's digests
            host = lambda d: tuple(int(v) for v in d.cpu().tolist())
            union = lambda parts: tuple(map(sum, zip(*map(host, parts))))
            missing = sorted(set(self.puts) ^ set(self.gets))
            if missing:
                raise AssertionError(f"puts without gets or gets without "
                                     f"puts: {missing[:5]}")
            for i in sorted(self.puts):
                if union(self.puts[i]) != union(self.gets[i]):
                    raise AssertionError(
                        f"batch {i}: its ring rows after the get differ "
                        f"from the emission at its put")
            for v, ds in self.replicas.items():
                bad = [r for r, d in enumerate(ds)
                       if host(d) != host(self.publishes[v])]
                if bad:
                    raise AssertionError(
                        f"publish {v}: learner placements {bad} hold agent "
                        f"params that differ from placement 0's")
            # version v is the publish after v - 1 consumed batches
            for i, v in self.rollouts:
                if not i - staleness <= v - 1 <= i:
                    raise AssertionError(
                        f"rollout {i} acted with params version {v}, "
                        f"outside the staleness bound {staleness}")
            for i, r, v, d in self.adopts:
                if host(d) != host(self.publishes[v]):
                    raise AssertionError(
                        f"rollout {i}, shard {r}: the params it read "
                        f"differ from publish {v}")
            out = {"batches": len(self.puts), "rollouts": len(self.rollouts),
                   "adopts": len(self.adopts),
                   "publishes": len(self.publishes)}
            if self.replicas:           # a learner set's placements
                out["replicas"] = sum(map(len, self.replicas.values()))
            return out


def describe(actor: Sequence[Placement], learner: Sequence[Placement]
             ) -> str:
    """E.g. "3 actor + 2 learner on cuda:0 as streams"."""
    devs = sorted({str(p.device) for p in (*actor, *learner)})
    if len(devs) == 1 and len(actor) + len(learner) > 1:
        how = "as streams" if actor[0].stream is not None else "in turns"
        return (f"{len(actor)} actor + {len(learner)} learner on "
                f"{devs[0]} {how}")
    return (f"{len(actor)} actor ({', '.join(str(p.device) for p in actor)})"
            f" + {len(learner)} learner "
            f"({', '.join(str(p.device) for p in learner)})")


def same_device(a, b) -> bool:
    """Whether two devices are one (``cuda`` is the current card)."""
    norm = lambda d: torch.device(d.type, torch.cuda.current_device()
                                  if d.type == "cuda" and d.index is None
                                  else d.index)
    return norm(torch.device(a)) == norm(torch.device(b))


def _on(place: Placement):
    """The placement's stream as the current one (nothing on the CPU)."""
    return (torch.cuda.stream(place.stream) if place.stream is not None
            else nullcontext())


def _event(place: Placement):
    """A CUDA event recorded now on the placement's stream (None on the
    CPU, where every program has finished when it returns)."""
    if place.stream is None:
        return None
    e = torch.cuda.Event()
    e.record(place.stream)
    return e


def _wait(place: Placement, events) -> None:
    if place.stream is None:
        return
    for e in events:
        if e is not None:
            place.stream.wait_event(e)


class ActorShard:
    """One placement of the actor set: its runner (over its lanes), its
    bound runner state, the static acting params its rollout reads and
    the static ``(T,)`` epsilons of the next training rollout."""

    def __init__(self, runner, place: Placement, rank: int):
        self.runner, self.place, self.rank = runner, place, rank
        self.rs = None                # the bound RunnerState
        self.params = None            # the bound acting params
        cfg = runner.cfg
        self.eps = torch.zeros(cfg.env_args.episode_limit,
                               device=place.device)
        self.graph = None             # Captured rollout (CUDA)
        self.pool = None


def _lane_map(n_actor: int, shard: int, n_learner: int, seat: int,
              lanes: int) -> Optional[Tuple[slice, slice]]:
    """The lanes of actor shard ``shard`` (global lane ``i·n_actor +
    shard`` is its lane ``i``) that learner placement ``seat`` holds
    (global lane ``j·n_learner + seat`` is its lane ``j``) → (the shard's
    lanes, the placement's lanes) as two slices of one length, or None
    when they share no lane. Both are arithmetic progressions."""
    pairs = [(i, g // n_learner)
             for i in range(lanes // n_actor)
             for g in (i * n_actor + shard,) if g % n_learner == seat]
    if not pairs:
        return None

    def as_slice(xs):
        step = xs[1] - xs[0] if len(xs) > 1 else 1
        if xs != list(range(xs[0], xs[0] + step * len(xs), step)):
            raise AssertionError(f"lanes {xs} are not a progression")
        return slice(xs[0], xs[0] + step * (len(xs) - 1) + 1, step)
    return (as_slice([i for i, _ in pairs]),
            as_slice([j for _, j in pairs]))


def _replay(stage):
    """Replay a captured stage (a graph, or segments split at
    collectives), count its kernels' launches → its static outputs."""
    if isinstance(stage, Segments):
        stage.replay()
        for kernel, n in stage.launches.items():
            attention.count_launch(kernel, n)
        for kernel, n in stage.mask_launches.items():
            dropout.count_launch(kernel, n)
        return stage.out
    return stage.replay()


class LearnerSeat:
    """Placement ``rank`` of the learner set (module docstring): its
    learner and ring (the experiment's, or with ``comm`` set a dp rank's
    of them on the placement's device), its bound learner side, its queue
    slots, the static inputs of its train stage (the key, PER's β, a
    population member's seams) and its graphs, in a pool of its own."""

    def __init__(self, exp, rank: int, place: Placement, comm,
                 queue_slots: int):
        self.rank, self.place, self.comm = rank, place, comm
        if same_device(place.device, exp.device):
            learner, buffer = exp.learner, exp.buffer
            if comm is not None:
                learner = dataclasses.replace(learner, comm=comm)
                buffer = dataclasses.replace(buffer, comm=comm)
        else:
            from ..run import Experiment
            other = Experiment.build(exp.cfg, place.device, comm=comm)
            learner, buffer = other.learner, other.buffer
        self.learner, self.buffer = learner, buffer
        self.train_iter = build_train_iter(buffer, learner, exp.cfg)
        dev = place.device
        self.key = torch.zeros(prng.IMPLS[exp.cfg.prng_impl],
                               dtype=torch.int64, device=dev)
        self.beta = torch.zeros((), device=dev)
        self.spec = None
        self.ls: Optional[LearnerSideState] = None
        self.queue: Optional[QueueState] = None
        self.get_graphs = [None] * queue_slots
        self.train_graph = None           # Captured, or Segments
        self.pool = None

    @property
    def launches(self) -> dict:
        """The attention kernels' launches of one train-stage replay."""
        return dict(self.train_graph.launches) if self.train_graph else {}


class Sebulba:
    """Decoupled actor/learner programs for an ``Experiment`` whose
    learner side is on the learner placements (module docstring).

    Usage (the ``run.run_sebulba`` shape)::

        seb = make_sebulba(exp)
        seb.place(exp.init_state(seed))     # bind the two halves
        seb.init_queue()
        seb.capture()                       # CUDA: every graph, up front
        actor_step, queue_put, queue_get, learner_step = seb.programs()
        version = seb.publish()
        seb.adopt(version)
        tms, stats = actor_step()           # every shard's rollout
        queue_put(slot, tms)
        queue_get(slot)                     # slot -> ring, episode += B
        info = learner_step(key, t_env)
    """

    def __init__(self, exp, actor: Sequence[Placement],
                 learner: Sequence[Placement], queue_slots: int,
                 member: Optional[int] = None, spec=None):
        cfg = exp.cfg
        if queue_slots < 1:
            raise ValueError(f"queue_slots must be >= 1, got {queue_slots}")
        n, n_l = len(actor), len(learner)
        if not n or not n_l:
            raise ValueError("the actor and learner sets must not be empty")
        if cfg.batch_size_run % n:
            raise ValueError(f"batch_size_run={cfg.batch_size_run} must "
                             f"divide over {n} actor placements")
        if n_l > 1 and (cfg.batch_size % n_l
                        or cfg.replay.buffer_size % n_l):
            raise ValueError(
                f"batch_size={cfg.batch_size} and replay.buffer_size="
                f"{cfg.replay.buffer_size} must divide over {n_l} learner "
                f"placements (replay episodes shard over the learner set)")
        streams = [p.stream for p in (*actor, *learner)
                   if p.stream is not None]
        if len(set(map(id, streams))) != len(streams):
            raise ValueError("actor and learner placements must be "
                             "disjoint: a shared stream re-serializes the "
                             "phases the split exists to overlap")
        self.exp, self.cfg = exp, cfg
        self.actor_places = tuple(actor)
        self.learner_places = tuple(learner)
        self.queue_slots = int(queue_slots)
        self.graphed = exp.device.type == "cuda"
        self.shards = [ActorShard(self._shard_runner(r, p, n), p, r)
                       for r, p in enumerate(actor)]
        self.group = PlacementGroup(learner) if n_l > 1 else None
        self.seats = [LearnerSeat(exp, r, p, self.group.comms[r]
                                  if self.group else None, self.queue_slots)
                      for r, p in enumerate(learner)]
        # a lane count the learner placements do not divide: an insert's
        # lanes land on the placements by the cursor, so every placement's
        # slots hold every lane and its insert picks its own
        self._whole = n_l > 1 and cfg.batch_size_run % n_l != 0
        self._maps = [[_lane_map(n, s, 1 if self._whole else n_l,
                                 0 if self._whole else r,
                                 cfg.batch_size_run)
                       for r in range(n_l)] for s in range(n)]
        self._per = hasattr(exp.buffer, "per_beta")
        self.snapshots = None         # two copies of the agent params
        self.version = 0              # publishes so far
        self._snap_version = [None, None]
        self._pub_events = [None, None]
        self._adopt_events = [[None] * n, [None] * n]
        self._put_events = [[] for _ in range(self.queue_slots)]
        self._get_events = [[None] * n_l for _ in range(self.queue_slots)]
        self.put_count = 0            # puts so far (the audit's index)
        self.get_count = 0
        self.capture_s = {}           # graph -> capture seconds
        #: the attention launches of ``capture``'s eager warm-up
        self.warm_launches = {k: 0 for k in attention.LAUNCHES}
        self.rollouts = 0             # training rollouts so far
        #: with ``timing`` on a CUDA device: CUDA event pairs around each
        #: training rollout's replay (one a shard) and each learner step's
        #: (placement 0's; ``learner_set``: every placement's)
        self.timing = False
        self.events = {"rollout": [], "learner": [], "learner_set": []}
        # a population member's seams (``member``: its global id; the
        # spec is static, PBT being refused under Sebulba): the rollout's
        # epsilon scale and scenario salt, the insert's and the feedback's
        # PER exponent, the update's lr scale, as ``SuperstepProgram``'s
        self.member = member
        self._eps_scale = self._salt = None
        if member is not None:
            lr, self._eps_scale, alpha, salt = spec.scalars(member)
            for seat in self.seats:
                dev = seat.place.device
                seat.spec = SimpleNamespace(
                    lr_scale=torch.full((), lr, device=dev),
                    per_alpha=torch.full((), alpha, device=dev))
            if cfg.population.scenario_salt:
                self._salt = salt

    # ------------------------------------------------------------ build

    def _shard_runner(self, rank: int, place: Placement, n: int):
        """Shard ``rank``'s runner on its device over its lanes (the
        experiment's runner as it is for a one-placement actor set on the
        learner's device)."""
        exp = self.exp
        shard = None if n == 1 else LaneShard(rank, n)
        if same_device(place.device, exp.device):
            return dataclasses.replace(exp.runner, comm=shard)
        from ..controllers.basic_mac import MAC_REGISTRY
        from ..envs.registry import make_env
        env = make_env(self.cfg.env_args, place.device, self.cfg.prng_impl)
        mac = MAC_REGISTRY[self.cfg.mac].build(self.cfg, env.get_env_info(),
                                               place.device)
        return type(exp.runner)(env, mac, self.cfg, comm=shard)

    @property
    def n_shards(self) -> int:
        return len(self.shards)

    @property
    def learner_place(self) -> Placement:
        """Placement 0 of the learner set (its params are published)."""
        return self.seats[0].place

    @property
    def ls(self) -> LearnerSideState:
        """Placement 0's learner side (its counters are every one's)."""
        return self.seats[0].ls

    @property
    def queue(self) -> Optional[QueueState]:
        return self.seats[0].queue

    @property
    def train_graph(self):
        return self.seats[0].train_graph

    def describe(self) -> str:
        return describe(self.actor_places, self.learner_places)

    def close(self) -> None:
        """End the learner set's threads (nothing at one placement)."""
        if self.group is not None:
            self.group.close()

    def _audit(self):
        """The race check's records of this program set (a member's own
        under a population), or None on the main path."""
        audit = AUDIT
        if audit is None or self.member is None:
            return audit
        return audit.member(self.member)

    # ------------------------------------------------------------ state

    def split(self, ts: TrainState):
        """→ (the shards' runner states, the learner placements' sides) of
        ``ts``, each on its placement: shard r holds rows ``r::n`` of every
        per-lane leaf and learner placement r the ring rows ``r::n`` (the
        ``DataParallel`` layout), each with its own copy of the rest;
        ``ts`` is left as it is."""
        n = self.n_shards
        rss = []
        for s in self.shards:
            dev = s.place.device

            def leaf(path, x, r=s.rank):
                if not isinstance(x, torch.Tensor):
                    return x
                if n > 1 and lane_sharded(path, x):
                    return lane_rows(x, r, n).to(dev)
                # every shard writes its runner state in place: a
                # replicated leaf is each shard's own copy
                return x.to(dev, copy=n > 1)
            rss.append(_rebuild(ts.runner, leaf, "runner"))
        n_l = len(self.seats)
        lss = []
        for seat in self.seats:
            dev = seat.place.device

            def leaf(path, x, r=seat.rank):
                if not isinstance(x, torch.Tensor):
                    return x
                if n_l > 1 and lane_sharded(path, x):
                    return lane_rows(x, r, n_l).to(dev)
                return x.to(dev, copy=n_l > 1)
            lss.append(LearnerSideState(
                learner=_rebuild(ts.learner, leaf, "learner"),
                buffer=_rebuild(ts.buffer, leaf, "buffer"),
                episode=leaf("episode", ts.episode)))
        return rss, lss

    def digest(self, lss=None) -> str:
        """A hash of the learner placements' replicated leaves (learner,
        ring counters, priorities, episode), checked equal on every
        placement (raises naming those that differ from placement 0),
        as ``DataParallel.digest`` checks the ranks'."""
        lss = [seat.ls for seat in self.seats] if lss is None else lss
        every = [replicated_digest(TrainState(
            learner=ls.learner, buffer=ls.buffer, episode=ls.episode))
            for ls in lss]
        bad = [r for r, d in enumerate(every) if d != every[0]]
        if bad:
            raise RuntimeError(f"learner placements {bad} hold replicated "
                               f"state that differs from placement 0's")
        return every[0]

    def join(self, rss=None, lss=None) -> TrainState:
        """The checkpointable ``TrainState`` of the shards' runner states
        (the bound ones when None) and the learner placements' sides: the
        runner's per-lane leaves in global lane order and, for a learner
        set, the ring rows in global slot order after ``digest``, on the
        learner's device."""
        rss = [s.rs for s in self.shards] if rss is None else rss
        lss = [seat.ls for seat in self.seats] if lss is None else lss
        dev = self.exp.device
        if len(rss) == 1:
            runner = rss[0]
        else:
            flat = [flatten_state(r)[0] for r in rss]

            def leaf(path, x):
                if not isinstance(x, torch.Tensor):
                    return x
                if lane_sharded(path, x):
                    rel = path[len("runner."):]
                    return interleave_rows([f[rel].to(dev) for f in flat])
                return x.to(dev)
            runner = _rebuild(rss[0], leaf, "runner")
        ls = lss[0]
        if len(lss) == 1:
            return TrainState(learner=ls.learner, runner=runner,
                              buffer=ls.buffer, episode=ls.episode)
        self.sync_learner()
        self.digest(lss)
        rings = [flatten_state(x.buffer)[0] for x in lss]

        def ring(path, x):
            if not isinstance(x, torch.Tensor):
                return x
            if lane_sharded(path, x):
                rel = path[len("buffer."):]
                return interleave_rows([f[rel].to(dev) for f in rings])
            return x.to(dev)
        return TrainState(learner=map_tensors(ls.learner,
                                              lambda x: x.to(dev)),
                          runner=runner,
                          buffer=_rebuild(ls.buffer, ring, "buffer"),
                          episode=ls.episode.to(dev))

    def place(self, ts: TrainState):
        """Bind ``ts``'s halves as the programs' state (the first call), or
        copy them into the bound tensors (a resume, a restore), with each
        shard's runner ``t_env``. → (the shards' runner states, placement
        0's learner side), the bound ones."""
        rss, lss = self.split(ts)
        for seat, ls in zip(self.seats, lss):
            if seat.ls is None:
                seat.ls = ls
            else:
                with _on(seat.place):
                    _copy_into(seat.ls, ls)
        for s, rs in zip(self.shards, rss):
            if s.rs is None:
                s.rs = rs
            else:
                with _on(s.place):
                    _copy_into(s.rs, rs)
                s.rs.t_env = rs.t_env
        if self.snapshots is None:
            agent = self.ls.learner.params["agent"]
            with _on(self.learner_place):
                self.snapshots = [map_tensors(agent, torch.clone)
                                  for _ in range(2)]
            for s in self.shards:
                with _on(s.place):
                    s.params = map_tensors(
                        agent, lambda x, d=s.place.device: x.to(d, copy=True))
        self._sync_all()
        return [s.rs for s in self.shards], self.ls

    def init_states(self, seed: int, learner_params=None):
        """Fresh state from ``seed`` (``Experiment.init_state``), placed."""
        return self.place(self.exp.init_state(seed,
                                              learner_params=learner_params))

    def runner_snapshot(self):
        """A finished copy of each shard's runner state: what a checkpoint
        taken meanwhile reads, while the shard's next rollout writes the
        bound one."""
        out = []
        for s in self.shards:
            with _on(s.place):
                out.append(map_tensors(s.rs, torch.clone))
        self.sync_actors()
        return out

    def _sync_all(self) -> None:
        for p in (*self.actor_places, *self.learner_places):
            if p.stream is not None:
                p.stream.synchronize()

    def sync_actors(self) -> None:
        """Block until every shard's enqueued work has finished."""
        for s in self.shards:
            if s.place.stream is not None:
                s.place.stream.synchronize()

    def sync_learner(self) -> None:
        """Block until every learner placement's work has finished."""
        for p in self.learner_places:
            if p.stream is not None:
                p.stream.synchronize()

    # ------------------------------------------------------------ queue

    def _scratch_rollout(self, s: ActorShard) -> None:
        """A training rollout of shard ``s`` on a copy of its runner state
        (the bound one is left as it is): the rollout's warm-up."""
        with _on(s.place):
            rs = clone_state(s.rs)
            eps = s.runner.epsilons(rs.t_env, self._eps_scale).to(
                s.place.device)
            s.runner.run_raw(s.params, rs, eps=eps, member=self._salt)
        self.sync_actors()

    def init_queue(self) -> QueueState:
        """The queue's slots, zero-filled on each learner placement: its
        lanes of a rollout's time-major emission (all of them where the
        placements do not divide the lane count), in the ring's dtypes and
        trailing shapes (``(T, B/n, ...)`` stacks, ``(B/n, ...)``
        bootstrap steps). → placement 0's."""
        t = self.cfg.env_args.episode_limit
        b = self.cfg.batch_size_run // (1 if self._whole
                                        else len(self.seats))
        for seat in self.seats:
            st = seat.ls.buffer.storage
            seq = lambda x: torch.zeros((t, b) + tuple(x.shape[2:]),
                                        dtype=x.dtype, device=x.device)
            last = lambda x: torch.zeros((b,) + tuple(x.shape[2:]),
                                         dtype=x.dtype, device=x.device)

            def slot():
                return TimeMajorEpisodes(
                    obs=obs_map(seq, st.obs), state=seq(st.state),
                    avail_actions=seq(st.avail_actions),
                    actions=seq(st.actions), reward=seq(st.reward),
                    terminated=seq(st.terminated),
                    last_obs=obs_map(last, st.obs),
                    last_state=last(st.state),
                    last_avail=last(st.avail_actions))
            with _on(seat.place):
                seat.queue = QueueState(slots=[slot() for _ in
                                               range(self.queue_slots)])
        self._sync_all()
        return self.queue

    def reset_queue(self) -> None:
        """A fresh epoch's queue bookkeeping (the slots' contents are
        overwritten by the puts): the host counters and the events."""
        self._put_events = [[] for _ in range(self.queue_slots)]
        self._get_events = [[None] * len(self.seats)
                            for _ in range(self.queue_slots)]
        self._pub_events = [None, None]
        self._snap_version = [None, None]
        self._adopt_events = [[None] * self.n_shards for _ in range(2)]
        self.put_count = self.get_count = 0
        self.version = 0
        self.acting_version = 0
        self.rollouts = 0

    # ------------------------------------------------------------ stages

    def _rollout_stage(self, s: ActorShard):
        rs, tm, stats = s.runner.run_raw(s.params, s.rs, eps=s.eps,
                                         member=self._salt)
        _copy_into(s.rs, rs)
        return tm, stats

    def _get_stage(self, seat: LearnerSeat, slot: int,
                   ls: LearnerSideState):
        buf = seat.buffer.insert_time_major(
            ls.buffer, seat.queue.slots[slot],
            alpha=None if seat.spec is None else seat.spec.per_alpha,
            whole=self._whole)
        _copy_into(ls, dataclasses.replace(
            ls, buffer=buf, episode=ls.episode + self.cfg.batch_size_run))

    def _train_stage(self, seat: LearnerSeat, ls: LearnerSideState):
        ts = TrainState(learner=ls.learner, buffer=ls.buffer,
                        episode=ls.episode)
        new, info = seat.train_iter(ts, seat.key, 0, beta=seat.beta,
                                    spec=seat.spec)
        _copy_into(ls, LearnerSideState(learner=new.learner,
                                        buffer=new.buffer,
                                        episode=new.episode))
        return info

    def _on_every_seat(self, fn) -> list:
        """``fn(seat)`` on every learner placement at once (one thread a
        placement for a set, ``PlacementGroup.run``) → the results."""
        if self.group is None:
            with _on(self.seats[0].place):
                return [fn(self.seats[0])]
        return self.group.run(lambda r: fn(self.seats[r]))

    def capture(self) -> dict:
        """On a CUDA device: warm every kind of stage once on a clone of
        the state, then capture every graph (module docstring). Call it
        after ``place`` and ``init_queue``, before any other thread
        enqueues work. → ``{graph: capture seconds}`` (empty on the CPU)."""
        if not self.graphed:
            return {}
        if self.queue is None:
            self.init_queue()
        before = dict(attention.LAUNCHES)
        # the process's warm-up, once a device (shared with the fused
        # superstep's: the same kernels, cuBLAS and autograd engine)
        for s in self.shards:
            warm = warm_key(s.place.device, "rollout")
            if warm not in _WARM:
                self._scratch_rollout(s)
                _WARM.add(warm)
        learner_warm = {warm_key(seat.place.device, "train")
                        for seat in self.seats}
        if not learner_warm <= _WARM:
            def warm(seat):
                ls = LearnerSideState(
                    learner=clone_state(seat.ls.learner),
                    buffer=clone_state(seat.ls.buffer),
                    episode=seat.ls.episode.clone())
                self._get_stage(seat, 0, ls)
                self._train_stage(seat, ls)
            self._on_every_seat(warm)
            self._sync_all()
            _WARM.update(learner_warm)
        # the eager warm-up's kernel launches (counted where they ran)
        self.warm_launches = {k: attention.LAUNCHES[k] - before[k]
                              for k in before}
        seconds = {}
        for s in self.shards:
            if s.graph is None:
                s.pool = torch.cuda.graph_pool_handle()
                s.place.stream.synchronize()
                s.graph = capture_graph(lambda s=s: self._rollout_stage(s),
                                        s.pool, s.place.stream)
                seconds[f"rollout{s.rank}"] = s.graph.capture_s
        for seat in self.seats:
            tag = "" if self.group is None else f"learner{seat.rank}_"
            stream = seat.place.stream
            if seat.pool is None:
                seat.pool = torch.cuda.graph_pool_handle()
            stream.synchronize()
            for slot in range(self.queue_slots):
                if seat.get_graphs[slot] is None:
                    seat.get_graphs[slot] = capture_graph(
                        lambda seat=seat, slot=slot: self._get_stage(
                            seat, slot, seat.ls), seat.pool, stream)
                    seconds[f"{tag}queue_get{slot}"] = \
                        seat.get_graphs[slot].capture_s
            if seat.train_graph is None:
                stage = lambda seat=seat: self._train_stage(seat, seat.ls)
                seat.train_graph = (
                    capture_graph(stage, seat.pool, stream)
                    if seat.comm is None else
                    capture_segments(stage, seat.pool, seat.comm, stream))
                seconds[f"{tag}learner_step"] = seat.train_graph.capture_s
        self._sync_all()
        self.capture_s.update(seconds)
        return seconds

    @property
    def learner_launches(self) -> dict:
        """The attention kernels' launches of one learner step's replays
        (summed over the learner placements: ``seat_launches`` has each
        placement's)."""
        out: dict = {}
        for seat in self.seats:
            for k, n in seat.launches.items():
                out[k] = out.get(k, 0) + n
        return out

    @property
    def seat_launches(self) -> List[dict]:
        return [seat.launches for seat in self.seats]

    # ------------------------------------------------------------ params

    def publish(self) -> int:
        """The learner→actor hop, on placement 0's stream: its agent params
        into the older snapshot (after every shard's last adopt of it) →
        the new version. Call under the driver's lock."""
        k = self.version % 2
        lp = self.learner_place
        audit = self._audit()
        with _on(lp):
            _wait(lp, self._adopt_events[k])
            _copy_into(self.snapshots[k], self.ls.learner.params["agent"])
            self.version += 1
            self._snap_version[k] = self.version
            self._pub_events[k] = _event(lp)
            if audit is not None:
                d = digest(list(flatten_state(self.snapshots[k])[0]
                                .values()))
                with audit.lock:
                    audit.publishes[self.version] = d
        if audit is not None and self.group is not None:
            # every learner placement's params, each on its own stream
            replicas = []
            for seat in self.seats:
                with _on(seat.place):
                    replicas.append(digest(list(flatten_state(
                        seat.ls.learner.params["agent"])[0].values())))
            with audit.lock:
                audit.replicas[self.version] = replicas
        return self.version

    def adopt(self, version: int) -> None:
        """Every shard copies the snapshot of ``version`` into its acting
        params, on its stream, after the publish's event. Call under the
        driver's lock."""
        k = (version - 1) % 2
        if self._snap_version[k] != version:
            raise RuntimeError(f"params version {version} is no longer "
                               f"published (snapshot holds "
                               f"{self._snap_version[k]})")
        self.acting_version = version
        audit = self._audit()
        for s in self.shards:
            with _on(s.place):
                _wait(s.place, [self._pub_events[k]])
                _copy_into(s.params, self.snapshots[k])
                self._adopt_events[k][s.rank] = _event(s.place)
                if audit is not None:
                    d = digest(list(flatten_state(s.params)[0].values()))
                    with audit.lock:
                        audit.adopts.append((self.rollouts, s.rank, version,
                                             d))

    # ------------------------------------------------------------ programs

    def programs(self):
        """→ (actor_step, queue_put, queue_get, learner_step):

        * ``actor_step(test_mode=False) -> (tms, stats)``: every shard's
          rollout (``runner.run_raw``) at its acting params, each on its
          placement; the shards' emissions (written in place of the last
          ones at the next call) and their stats merged in global lane
          order. A training rollout replays the shard's graph (CUDA) and
          advances the runner's ``t_env``; a test rollout runs eagerly and
          leaves ``t_env``. It returns when every shard has finished (the
          actor's barrier: its span is the rollout's device time).
        * ``queue_put(slot, tms)``: each shard's emission into the lanes
          of the slot that each learner placement holds, on the shard's
          stream, after the slot's last gets.
        * ``queue_get(slot)``: on each learner placement, its lanes of the
          slot into its ring rows (``insert_time_major``) and ``episode +=
          batch_size_run``, on its stream after the slot's puts.
        * ``learner_step(key, t_env) -> info``: ``build_train_iter``'s
          sample → train → guarded priority feedback (→ the sight PER read)
          with ``key`` split as ``run._train_iter`` splits it, on every
          learner placement at once; placement 0's info copied out of the
          graph's outputs (every placement's is the same).
        """
        return self.actor_step, self.queue_put, self.queue_get, \
            self.learner_step

    def actor_step(self, test_mode: bool = False):
        with record_function("actor_step"):
            outs = self.launch_rollouts(test_mode)
            # the actor's barrier: the stats are read from here on, and
            # the next replay overwrites the graphs' outputs
            self.sync_actors()
        return self.finish_rollouts(outs, test_mode)

    def launch_rollouts(self, test_mode: bool = False) -> list:
        """``actor_step``'s enqueue: every shard's rollout on its stream,
        without the barrier. → what ``finish_rollouts`` takes."""
        spr = self.cfg.batch_size_run * self.cfg.env_args.episode_limit
        audit = self._audit()
        if audit is not None and not test_mode:
            with audit.lock:
                audit.rollouts.append((self.rollouts, self.acting_version))
        outs, timed = [], []
        for s in self.shards:
            with _on(s.place):
                if test_mode:
                    rs, tm, stats = s.runner.run_raw(s.params, s.rs,
                                                     test_mode=True)
                    _copy_into(s.rs, rs)
                else:
                    eps = s.runner.epsilons(s.rs.t_env, self._eps_scale)
                    if s.place.stream is not None:
                        eps = eps.pin_memory()
                    s.eps.copy_(eps, non_blocking=True)
                    marks = self._mark(s.place)
                    tm, stats = (s.graph.replay() if s.graph is not None
                                 else self._rollout_stage(s))
                    if marks is not None:
                        marks[1].record(s.place.stream)
                        timed.append(marks)
                    s.rs.t_env += spr
            outs.append((tm, stats))
        if timed:
            self.events["rollout"].append(timed)
        return outs

    def finish_rollouts(self, outs: list, test_mode: bool = False):
        """``actor_step``'s return, after the barrier: the emissions and
        the stats in global lane order."""
        if not test_mode:
            self.rollouts += 1
        stats = self.merge_stats([o[1] for o in outs])
        if self.n_shards == 1:
            stats = map_tensors(stats, torch.clone)
        return [o[0] for o in outs], stats

    #: the params version the next training rollout acts with
    acting_version = 0

    def merge_stats(self, stats: Sequence):
        """The shards' per-lane ``RolloutStats`` in global lane order, on
        shard 0's device (the shards' work must have finished)."""
        if len(stats) == 1:
            return stats[0]
        dev = self.shards[0].place.device
        first = stats[0]
        out = {}
        for f in dataclasses.fields(first):
            v = getattr(first, f.name)
            if f.name == "epsilon" or v.ndim == 0:
                out[f.name] = v
            else:
                out[f.name] = interleave_rows(
                    [getattr(s, f.name).to(dev) for s in stats])
        return type(first)(**out)

    def queue_put(self, slot: int, tms: Sequence[TimeMajorEpisodes]) -> None:
        events, parts = [], []
        audit = self._audit()
        for s, tm in zip(self.shards, tms):
            with _on(s.place):
                _wait(s.place, self._get_events[slot])
                for seat in self.seats:
                    lanes = self._maps[s.rank][seat.rank]
                    if lanes is None:
                        continue

                    def put(d, x, axis, src=lanes[0], dst=lanes[1]):
                        at = [slice(None)] * d.ndim
                        at[axis] = dst
                        of = [slice(None)] * x.ndim
                        of[axis] = src
                        d[tuple(at)].copy_(x[tuple(of)], non_blocking=True)
                        return d
                    tm_map(put, seat.queue.slots[slot], tm)
                if audit is not None:
                    parts.append(digest(tm_leaves(tm)))
                events.append(_event(s.place))
        self._put_events[slot] = events
        if audit is not None:
            with audit.lock:
                audit.puts[self.put_count] = parts
        self.put_count += 1

    def _ring_digest(self, seat: LearnerSeat, pos: torch.Tensor):
        """The digest of the ring rows placement ``seat`` wrote in the
        insert that began at the global cursor ``pos``."""
        b, cap = self.cfg.batch_size_run, self.exp.buffer.capacity
        n = len(self.seats)
        idx = (pos + torch.arange(b, device=pos.device)) % cap
        # the slots the placement holds (r::n of them when n divides b)
        rows = (idx[seat.rank::n] if not self._whole
                else idx[idx % n == seat.rank]) // n
        st = seat.ls.buffer.storage
        leaves = []
        for f in dataclasses.fields(st):
            if f.name == "filled":
                continue
            obs_map(lambda x: leaves.append(x.index_select(0, rows)) or x,
                    getattr(st, f.name))
        return digest(leaves)

    def queue_get(self, slot: int) -> None:
        audit = self._audit()
        parts = []
        for seat in self.seats:
            with _on(seat.place):
                _wait(seat.place, self._put_events[slot])
                pos = seat.ls.buffer.insert_pos.clone() if audit else None
                if seat.get_graphs[slot] is not None:
                    seat.get_graphs[slot].replay()
                else:
                    self._get_stage(seat, slot, seat.ls)
                self._get_events[slot][seat.rank] = _event(seat.place)
                if audit is not None:
                    parts.append(self._ring_digest(seat, pos))
        if audit is not None:
            with audit.lock:
                audit.gets[self.get_count] = parts
        self.get_count += 1

    def learner_step(self, key: torch.Tensor, t_env: int) -> dict:
        lead = self.seats[0].place
        beta = self.exp.buffer.per_beta(t_env) if self._per else None
        # the caller's stream: where ``key`` was made and the info is read
        caller = (torch.cuda.current_stream(lead.device)
                  if lead.stream is not None else None)
        made = _event(Placement(lead.device, caller))

        def step(seat):
            place = seat.place
            with record_function("learner_step"):
                _wait(place, [made])
                seat.key.copy_(key, non_blocking=True)
                if beta is not None:
                    seat.beta.fill_(beta)
                marks = self._mark(place)
                info = (_replay(seat.train_graph)
                        if seat.train_graph is not None
                        else self._train_stage(seat, seat.ls))
                if marks is not None:
                    marks[1].record(place.stream)
                if seat.rank:
                    return None, marks
                return {k: v.clone() for k, v in info.items()}, marks
        outs = self._on_every_seat(step)
        if outs[0][1] is not None:
            self.events["learner"].append(outs[0][1])
            if self.group is not None:
                self.events["learner_set"].append([m for _, m in outs])
        if caller is not None and caller != lead.stream:
            caller.wait_event(_event(lead))
        return outs[0][0]

    def _mark(self, place: Placement):
        """With ``timing`` on a stream: (start event recorded now, end
        event to record) for a replay, else None."""
        if not self.timing or place.stream is None:
            return None
        marks = (torch.cuda.Event(enable_timing=True),
                 torch.cuda.Event(enable_timing=True))
        marks[0].record(place.stream)
        return marks


class PopulationSebulba:
    """Population × Sebulba (JAX's ``population=P`` ``Sebulba``), in
    lockstep only: one :class:`Sebulba` a member, each with the member's
    seams (its global id's spec row and scenario salt), its own queue and
    params snapshots. The members split over the actor placements by
    ``mesh.member_blocks``: member ``m`` runs its rollout, its lanes whole,
    on actor placement ``m // (P/n)``'s stream, and its learner programs,
    its learner and ring whole, on learner placement ``m // (P/n_l)``'s
    (JAX shards the member axis over the learner mesh): members never
    communicate, so there is no gradient sum, and a learner step enqueues
    every member's in member order, the placements' streams overlapping
    on the card. The programs take
    and return what ``Sebulba``'s do with a leading member axis: a queue
    slot carries every member's emission, ``learner_step`` takes ``(P,
    2)`` keys and returns ``(P, ...)`` infos, ``join`` gives the
    ``population.PopState`` the classic population loop checkpoints."""

    def __init__(self, exp, actor: Sequence[Placement],
                 learner: Sequence[Placement], queue_slots: int, spec):
        p = int(exp.cfg.population.size)
        self.exp, self.cfg, self.spec = exp, exp.cfg, spec
        self.actor_places = tuple(actor)
        self.learner_places = tuple(learner)
        of = lambda n: [b for b, blk in enumerate(member_blocks(p, n))
                        for _ in blk]
        self.placement_of = of(len(actor))
        self.learner_of = of(len(learner))
        self.members = [Sebulba(exp, (actor[self.placement_of[m]],),
                                (learner[self.learner_of[m]],), queue_slots,
                                member=m, spec=spec)
                        for m in range(p)]
        self.learner_place = self.members[0].learner_place

    @property
    def ls(self) -> LearnerSideState:
        """Member 0's learner side: its counters are every member's."""
        return self.members[0].ls

    def describe(self) -> str:
        p, n_l = len(self.members), len(self.learner_places)
        return (f"{describe(self.actor_places, self.learner_places)}, "
                f"a population of {p} ({p // len(self.actor_places)} "
                f"members a placement"
                + (f", {p // n_l} a learner placement" if n_l > 1 else "")
                + ")")

    @property
    def timing(self) -> bool:
        return self.members[0].timing

    @timing.setter
    def timing(self, on: bool) -> None:
        for m in self.members:
            m.timing = on

    @property
    def events(self) -> dict:
        """Every member's timing events, member after member."""
        return {k: [e for m in self.members for e in m.events[k]]
                for k in ("rollout", "learner")}

    @property
    def capture_s(self) -> dict:
        return {f"pop{i}_{k}": v for i, m in enumerate(self.members)
                for k, v in m.capture_s.items()}

    @property
    def learner_launches(self) -> dict:
        """The attention launches of one learner step of every member."""
        out: dict = {}
        for m in self.members:
            for k, n in m.learner_launches.items():
                out[k] = out.get(k, 0) + n
        return out

    # ------------------------------------------------------------ state

    def place(self, state):
        """Bind (or copy in) a ``PopState``'s members, each onto its
        placement."""
        for m, ts in zip(self.members, state.ts):
            m.place(ts)

    def init_states(self, seed: int, learner_params=None):
        """Fresh members (``population.init_population``), placed."""
        from ..population import PopState, init_population
        pts, spec = init_population(self.exp, self.cfg, learner_params)
        self.place(PopState(ts=pts, spec=spec))

    def join(self, rss=None):
        """The ``PopState`` of every member (``Sebulba.join`` each, with
        ``rss`` a member's runner snapshots)."""
        from ..population import PopState
        rss = [None] * len(self.members) if rss is None else rss
        return PopState(ts=[m.join(r) for m, r in zip(self.members, rss)],
                        spec=self.spec)

    def runner_snapshot(self) -> list:
        return [m.runner_snapshot() for m in self.members]

    def init_queue(self):
        for m in self.members:
            m.init_queue()

    def reset_queue(self) -> None:
        for m in self.members:
            m.reset_queue()

    def capture(self) -> dict:
        for m in self.members:
            m.capture()
        return self.capture_s

    def sync_actors(self) -> None:
        for m in self.members:
            m.sync_actors()

    def sync_learner(self) -> None:
        for m in self.members:
            m.sync_learner()

    def close(self) -> None:
        for m in self.members:
            m.close()

    # ------------------------------------------------------------ params

    def publish(self) -> int:
        """Every member's publish (their versions move together)."""
        return [m.publish() for m in self.members][0]

    def adopt(self, version: int) -> None:
        for m in self.members:
            m.adopt(version)

    # ------------------------------------------------------------ programs

    def programs(self):
        return self.actor_step, self.queue_put, self.queue_get, \
            self.learner_step

    def actor_step(self, test_mode: bool = False):
        """Every member's rollout, each enqueued on its placement's stream
        before the one barrier (the placements' members overlap). → (each
        member's emissions, the ``(P, B)`` stats)."""
        with record_function("actor_step"):
            launched = [m.launch_rollouts(test_mode) for m in self.members]
            self.sync_actors()
        outs = [m.finish_rollouts(o, test_mode)
                for m, o in zip(self.members, launched)]
        first = outs[0][1]
        stats = type(first)(**{
            f.name: torch.stack([torch.as_tensor(getattr(o[1], f.name))
                                 .to(first.episode_return.device)
                                 for o in outs])
            for f in dataclasses.fields(first)})
        return [o[0] for o in outs], stats

    def queue_put(self, slot: int, tms) -> None:
        for m, tm in zip(self.members, tms):
            m.queue_put(slot, tm)

    def queue_get(self, slot: int) -> None:
        for m in self.members:
            m.queue_get(slot)

    def learner_step(self, keys, t_env: int) -> dict:
        """Every member's learner step in member order, ``keys[m]`` its
        key. → the ``(P, ...)`` info stacks."""
        infos = [m.learner_step(k, t_env)
                 for m, k in zip(self.members, keys)]
        dev = self.exp.device
        return {k: torch.stack([i[k].to(dev) for i in infos])
                for k in infos[0]}


def make_sebulba(exp, placements: Optional[Tuple] = None,
                 share_cards: bool = False, spec=None):
    """The Sebulba machinery from ``exp.cfg.sebulba`` (the driver's entry):
    ``placements`` (the ``(actor, learner)`` pair of
    ``mesh.partition_devices``), or the partition of ``exp``'s device
    (the CPU: every placement the CPU; a card: its cards, or with
    ``share_cards`` streams of card 0). Under a population, a
    :class:`PopulationSebulba` over ``spec`` (the config's grids when
    None)."""
    sb = exp.cfg.sebulba
    if placements is None:
        placements = partition_devices(
            sb.actor_devices, sb.learner_devices,
            devices="cpu" if exp.device.type != "cuda" else None,
            share_cards=share_cards)
    actor, learner = placements
    if exp.cfg.population.size:
        from ..population import build_spec
        return PopulationSebulba(exp, actor, learner, sb.queue_slots,
                                 build_spec(exp.cfg) if spec is None
                                 else spec)
    return Sebulba(exp, actor, learner, sb.queue_slots)
