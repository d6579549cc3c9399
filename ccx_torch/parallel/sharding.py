"""Device-mesh sharding of the cluster model and the search.

The port of the JAX package's ``ccx/parallel/sharding.py``, with the same
names. A ``Mesh`` is a ``chains x parts`` grid of ``torch.device``s:

* ``chains``: data parallelism over independent SA chains; each chain rank
  holds its own block of chains, and the only step across chain ranks is
  the final lexicographic argmin;
* ``parts``: the model's partition axis cut into contiguous blocks, one per
  parts rank. Broker aggregates are segment sums over partitions, so each
  block reduces its rows and one ``psum`` gives the global aggregates.

One controller drives every shard, as one ``shard_map`` program does in
JAX: one Python process issues each shard's launches onto that shard's
device, and a ``psum`` over ``parts`` is the sum of the shards' partials in
rank order onto the receiving device (bools summed as int32 and compared
``> 0``). On one physical device (the virtual mesh,
``ccx_torch.common.vmesh``) that sum is an add; across cards it is a peer
copy and an add. Where JAX runs a computation on replicated inputs once per
device with identical results, the controller runs it once per chain rank,
on the rank's lead device (its parts rank 0), and every shard reads that
one result: identical values, computed once. The partition-axis tensors of
the model and the search's placement rows stay in their blocks for the
whole run; they are never replicated.

``program_cache_stats`` keeps JAX's keys (``run``, ``eval``, ``max``). JAX
counts compiled shard_map programs; the port compiles nothing per shape, so
it counts the shard plans its calls register per shape instead
(``ShardPlan``: the mesh, the blocks' offsets and the static step
configuration), keyed as JAX keys its programs and bounded as JAX bounds
them. The counter answers the question JAX's answers: a budget or schedule
retune of a chunked run adds no entry.

On the card, the aggregates kernel runs once per block on ``P / parts``
rows. Its topic index is cached per block tensor
(``ops.broker_aggregates.topic_index`` keys on the tensor objects), so the
blocks of one model never share an index. The kernel scales its 64-bit
fixed-point sums from each call's own largest load, so a block's partial is
rounded on its own scale and the psummed float aggregates can differ from
the unsharded call in the last bits: equal "up to float reduction order",
as JAX states its own sharded results.
"""

from __future__ import annotations

import dataclasses
import logging
from collections import OrderedDict

import torch

from ccx_torch.common import costmodel
from ccx_torch.common.vmesh import devices as vmesh_devices
from ccx_torch.goals import partition_terms as pt
from ccx_torch.goals import topic_terms as tt
from ccx_torch.goals.base import GOAL_REGISTRY, GoalConfig
from ccx_torch.goals.stack import DEFAULT_GOAL_ORDER, StackResult
from ccx_torch.model.aggregates import BROKER_FIELDS, BrokerAggregates, broker_aggregates
from ccx_torch.model.tensor_model import TENSOR_FIELDS, TensorClusterModel

CHAINS_AXIS = "chains"
PARTS_AXIS = "parts"

log = logging.getLogger(__name__)


class Mesh:
    """A ``chains x parts`` grid of devices (a device may appear more than
    once: the virtual mesh names one physical device N times)."""

    axis_names = (CHAINS_AXIS, PARTS_AXIS)

    def __init__(self, grid) -> None:
        self.devices = tuple(tuple(torch.device(d) for d in row) for row in grid)
        if not self.devices or not self.devices[0]:
            raise ValueError("a mesh needs at least one device")

    @property
    def shape(self) -> dict[str, int]:
        return {CHAINS_AXIS: len(self.devices), PARTS_AXIS: len(self.devices[0])}

    @property
    def size(self) -> int:
        return len(self.devices) * len(self.devices[0])

    def device(self, chain_rank: int, part_rank: int) -> torch.device:
        return self.devices[chain_rank][part_rank]

    @property
    def key(self) -> tuple:
        return tuple(tuple(str(d) for d in row) for row in self.devices)

    def __eq__(self, other) -> bool:
        return isinstance(other, Mesh) and self.key == other.key

    def __hash__(self) -> int:
        return hash(self.key)

    def __repr__(self) -> str:
        return f"Mesh({self.shape}, {self.key})"


def make_mesh(devices: list | None = None, parts: int | None = None) -> Mesh:
    """A (chains x parts) mesh over the given devices (default: every
    device of ``ccx_torch.common.vmesh.devices()``).

    By default the device count is split with a small ``parts`` factor:
    partition-axis sharding pays only for very large clusters, while chain
    parallelism needs no collective."""
    if devices is None:
        devices = vmesh_devices()
    devices = list(devices)
    n = len(devices)
    if parts is None:
        parts = 2 if n % 2 == 0 and n > 1 else 1
    chains = n // parts if parts > 0 else 0
    if parts <= 0 or chains * parts != n or n == 0:
        raise ValueError(f"{n} devices not divisible into parts={parts}")
    return Mesh([devices[c * parts:(c + 1) * parts] for c in range(chains)])


def model_pspecs(m: TensorClusterModel) -> dict[str, tuple]:
    """The partition spec of every tensor field, as JAX's
    ``PartitionSpec`` tuples: the partition-axis fields shard over
    ``parts`` (on the axis that names it); broker, disk and topic fields
    are replicated (``()``): they are O(B) and every shard scores
    aggregates against them."""
    del m  # every model has the same specs
    specs = {
        "assignment": (PARTS_AXIS, None),
        "leader_slot": (PARTS_AXIS,),
        "replica_disk": (PARTS_AXIS, None),
        "partition_valid": (PARTS_AXIS,),
        "partition_topic": (PARTS_AXIS,),
        "partition_immovable": (PARTS_AXIS,),
        "leader_load": (None, PARTS_AXIS),
        "follower_load": (None, PARTS_AXIS),
    }
    return {name: specs.get(name, ()) for name in TENSOR_FIELDS}


def _parts_dim(spec: tuple) -> int | None:
    return spec.index(PARTS_AXIS) if PARTS_AXIS in spec else None


@dataclasses.dataclass(frozen=True)
class ShardedModel:
    """A model placed on a mesh: ``blocks[c][p]`` is partition block ``p``
    (global rows ``p * P_local`` up to ``(p + 1) * P_local``) with the
    broker, disk and topic fields replicated, on ``mesh.device(c, p)``."""

    mesh: Mesh
    blocks: tuple[tuple[TensorClusterModel, ...], ...]
    P: int

    @property
    def P_local(self) -> int:
        return self.blocks[0][0].P

    @property
    def offsets(self) -> tuple[int, ...]:
        return tuple(p * self.P_local for p in range(len(self.blocks[0])))

    @property
    def num_topics(self) -> int:
        return self.blocks[0][0].num_topics

    @property
    def device(self) -> torch.device:
        return self.blocks[0][0].device


def shard_model(m: TensorClusterModel | ShardedModel, mesh: Mesh) -> ShardedModel:
    """Place ``m`` on ``mesh`` with the partition axis cut into contiguous
    blocks of the padded P, one per parts rank (a device the mesh names
    twice gets one copy)."""
    if isinstance(m, ShardedModel):
        if m.mesh == mesh:
            return m
        m = unshard(m, m.device)
    parts = mesh.shape[PARTS_AXIS]
    if m.P % parts:
        raise ValueError(f"padded P={m.P} not divisible by parts={parts}")
    p_local = m.P // parts
    specs = model_pspecs(m)
    made: dict[tuple[int, str], TensorClusterModel] = {}

    def block(p: int, dev: torch.device) -> TensorClusterModel:
        key = (p, str(dev))
        if key not in made:
            fields = {}
            for name in TENSOR_FIELDS:
                x = getattr(m, name)
                dim = _parts_dim(specs[name])
                if dim is not None:
                    x = x.narrow(dim, p * p_local, p_local)
                fields[name] = x.to(dev).contiguous()
            made[key] = m.replace(**fields)
        return made[key]

    blocks = tuple(
        tuple(block(p, dev) for p, dev in enumerate(row)) for row in mesh.devices
    )
    return ShardedModel(mesh=mesh, blocks=blocks, P=m.P)


def unshard(sm: ShardedModel, device) -> TensorClusterModel:
    """Chain rank 0's blocks joined back into one model on ``device``."""
    blocks = sm.blocks[0]
    specs = model_pspecs(blocks[0])
    fields = {}
    for name in TENSOR_FIELDS:
        dim = _parts_dim(specs[name])
        if dim is None:
            fields[name] = getattr(blocks[0], name).to(device)
        else:
            fields[name] = torch.cat([getattr(b, name).to(device) for b in blocks], dim=dim)
    return blocks[0].replace(**fields)


def _tree_map(fn, x):
    """``fn`` on every tensor of ``x`` (tensors, dataclasses, tuples, lists
    and dicts of them); other leaves are kept."""
    if torch.is_tensor(x):
        return fn(x)
    if dataclasses.is_dataclass(x) and not isinstance(x, type):
        return dataclasses.replace(x, **{
            f.name: _tree_map(fn, getattr(x, f.name)) for f in dataclasses.fields(x) if f.init
        })
    if isinstance(x, (tuple, list)):
        return type(x)(_tree_map(fn, v) for v in x)
    if isinstance(x, dict):
        return {k: _tree_map(fn, v) for k, v in x.items()}
    return x


def replicate(x, mesh: Mesh) -> list:
    """One copy of the tree ``x`` per mesh device, in row-major order (a
    device the mesh names twice gets the same tensors)."""
    copies: dict[str, object] = {}
    out = []
    for row in mesh.devices:
        for dev in row:
            if str(dev) not in copies:
                copies[str(dev)] = _tree_map(lambda t, d=dev: t.to(d), x)
            out.append(copies[str(dev)])
    return out


def psum(xs: list[torch.Tensor], device) -> torch.Tensor:
    """The sum over ``parts`` of the shards' ``xs``, in rank order, on
    ``device``; bools are summed as int32 and compared ``> 0``."""
    is_bool = xs[0].dtype == torch.bool
    acc = None
    for x in xs:
        x = x.to(device)
        if is_bool:
            x = x.to(torch.int32)
        acc = x if acc is None else acc + x
    return acc > 0 if is_bool else acc


def _psum_tree(trees: list, device):
    """``psum`` field by field over a list of equal dataclasses."""
    first = trees[0]
    if torch.is_tensor(first):
        return psum(trees, device)
    return dataclasses.replace(first, **{
        f.name: _psum_tree([getattr(t, f.name) for t in trees], device)
        for f in dataclasses.fields(first) if f.init
    })


def _mask_view(view, owned: torch.Tensor):
    """Zero a PartitionView's contribution on a non-owner shard, so the
    psum over shards gives the owner's values (``owned`` broadcasts over
    the trailing axes)."""

    def mask(x):
        ow = owned.reshape(owned.shape + (1,) * (x.dim() - owned.dim()))
        if x.dtype == torch.bool:
            return x & ow
        return x * ow.to(x.dtype)

    return _tree_map(mask, view)


# --------------------------------------------------------------------------
# Shard plans and their caches
# --------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class ShardPlan:
    """One shape's entry in the plan caches: the mesh, the padded P, the
    blocks' offsets and the static configuration the entry was keyed on (a
    chunk's engine and step sizes)."""

    mesh_key: tuple
    P: int
    offsets: tuple[int, ...]
    config: tuple = ()


#: Bounded LRU, as JAX bounds its compiled-program caches.
_CACHE_MAX = 8
#: (mesh, goal_names, cfg, struct) -> the stack evaluator's plan
_EVAL_CACHE: OrderedDict = OrderedDict()
#: tagged keys share one LRU: ("init", ...) the chains' start, ("chunk",
#: ...) the chunk driver's plan (n_steps/t1/ramp retunes hit the same
#: entry), ("run", ...) the one-shot run
_RUN_CACHE: OrderedDict = OrderedDict()


def _struct_key(m: TensorClusterModel | ShardedModel) -> tuple:
    """Shapes and dtypes of every tensor field (no data)."""
    base = m.blocks[0][0] if isinstance(m, ShardedModel) else m
    P = m.P
    return (P,) + tuple(
        (name, tuple(getattr(base, name).shape), str(getattr(base, name).dtype))
        for name in TENSOR_FIELDS
    ) + (base.num_topics, base.num_racks)


def _plan(cache: OrderedDict, key: tuple, mesh: Mesh, P: int, config: tuple = ()) -> ShardPlan:
    plan = cache.get(key)
    if plan is not None:
        cache.move_to_end(key)
        return plan
    parts = mesh.shape[PARTS_AXIS]
    plan = ShardPlan(mesh_key=mesh.key, P=P,
                     offsets=tuple(p * (P // parts) for p in range(parts)), config=config)
    cache[key] = plan
    while len(cache) > _CACHE_MAX:
        cache.popitem(last=False)
    return plan


def program_cache_stats() -> dict:
    """Live shard-plan cache occupancy (the ``shardedPrograms`` block of a
    result and of the façade's state), keyed as JAX's compiled-program
    counts: a budget retune never adds an entry."""
    return {"run": len(_RUN_CACHE), "eval": len(_EVAL_CACHE), "max": _CACHE_MAX}


# --------------------------------------------------------------------------
# The sharded stack evaluation
# --------------------------------------------------------------------------


def _block_sums(blocks) -> tuple[BrokerAggregates, torch.Tensor]:
    """Every block's aggregates pass and partition-goal sums, psummed onto
    the lead block's device."""
    dev = blocks[0].device
    agg = _psum_tree([broker_aggregates(b) for b in blocks], dev)
    sums = psum([
        pt.partition_sums(b, b.assignment, b.leader_slot, b.replica_disk, b.partition_valid)
        for b in blocks
    ], dev)
    return agg, sums


@costmodel.instrument("sharded-stack-eval")
def _eval_blocks(blocks: tuple, cfg: GoalConfig, goal_names: tuple[str, ...]):
    lead = blocks[0]
    agg, psums = _block_sums(blocks)
    part_idx = {n: i for i, n in enumerate(pt.PARTITION_GOALS)}
    inv_np = 1.0 / agg.leader_count.sum().float().clamp(min=1.0)
    vio, cost = [], []
    for name in goal_names:
        if name in part_idx:
            v = psums[part_idx[name]]
            c = v * inv_np if name == "PreferredLeaderElectionGoal" else v
        elif name == "KafkaAssignerEvenRackAwareGoal":
            # the rack half from the psummed row sums, the leader-evenness
            # half from the (already global) aggregates
            alive = lead.broker_valid & lead.broker_alive
            n_alive = alive.sum().float().clamp(min=1.0)
            avg = agg.leader_count.sum().float() / n_alive
            over = torch.where(alive, (agg.leader_count - torch.ceil(avg)).clamp(min=0), 0.0)
            rack = psums[part_idx["RackAwareGoal"]]
            v = rack + (over > 0).sum().float()
            c = rack + over.sum() / avg.clamp(min=1e-9)
        else:
            r = GOAL_REGISTRY[name].fn(lead, agg, cfg)
            v, c = r.violations, r.cost
        vio.append(v.float())
        cost.append(c.float())
    return torch.stack(vio), torch.stack(cost)


def sharded_stack_eval(
    m: TensorClusterModel | ShardedModel,
    cfg: GoalConfig = GoalConfig(),
    goal_names: tuple[str, ...] = DEFAULT_GOAL_ORDER,
    mesh: Mesh | None = None,
) -> StackResult:
    """``evaluate_stack`` with the partition axis sharded over ``parts``.

    Each block runs the aggregates pass and ``partition_sums`` on its rows;
    one ``psum`` gives the globals; the goal kernels then score the
    replicated broker state. Equal to
    ``ccx_torch.goals.stack.evaluate_stack`` up to float reduction order.
    Accepts every searchable stack, the kafka-assigner mode's decomposed
    KafkaAssignerEvenRackAwareGoal included (the decomposition of
    ``ccx_torch.search.state``). The replicated chain ranks would compute
    the same result, so chain rank 0's blocks compute it."""
    from ccx_torch.search.state import check_searchable

    if mesh is None:
        mesh = m.mesh if isinstance(m, ShardedModel) else make_mesh()
    check_searchable(goal_names)
    sm = shard_model(m, mesh)
    _plan(_EVAL_CACHE, (mesh.key, tuple(goal_names), cfg, _struct_key(sm)), mesh, sm.P)
    violations, costs = _eval_blocks(sm.blocks[0], cfg, tuple(goal_names))
    return StackResult(
        names=tuple(goal_names),
        hard_mask=tuple(GOAL_REGISTRY[n].hard for n in goal_names),
        violations=violations,
        costs=costs,
    )


# --------------------------------------------------------------------------
# Partition-axis-sharded simulated annealing
# --------------------------------------------------------------------------


class _ChainRank:
    """One chain rank of a sharded run, a chain group of the annealer's
    driver (``annealer.ChainGroup``): the replicated state of chains
    ``lo:hi`` on the rank's lead device, and its placement rows per parts
    rank. ``gather`` and ``place`` are the step functions' hooks: the owner
    gather of a drawn partition's view (masked on non-owners, psummed) and
    the owner write of an accepted row (the replicated grouped mirror is
    written on the lead device)."""

    def __init__(self, c: int, lo: int, hi: int, sm: ShardedModel, cfg: GoalConfig,
                 goal_names: tuple[str, ...], group, evac: torch.Tensor, pp, engine: str,
                 moves: int) -> None:
        from ccx_torch.search.annealer import step_kwargs
        from ccx_torch.search.state import NUM_MOVE_KINDS, SearchState, make_cost_vector_fn

        self.lo, self.hi = lo, hi
        self.blocks = sm.blocks[c]
        self.offsets = sm.offsets
        self.p_local = sm.P_local
        lead = self.blocks[0]
        self.lead = lead
        self.device = dev = lead.device
        C = hi - lo
        self.group = None if group is None else _tree_map(lambda t: t.to(dev), group)
        agg, part_sums = _block_sums(self.blocks)
        mtl_sum = tt.mtl_row(lead, cfg, lead.topic_min_leaders, agg.topic_leader_count).sum()
        pen, _ = tt.trd_row_pen(lead, cfg, agg.topic_replica_count)
        trd_sum = pen.sum()
        topic_totals = tt.trd_row_total(lead, agg.topic_replica_count)
        cost_vec = make_cost_vector_fn(lead, goal_names, cfg)(
            agg, part_sums, mtl_sum, trd_sum, tt.trd_normalizer(lead, topic_totals)
        )
        ga = gl = None
        if self.group is not None:
            ga, gl = self._mirror(self.group.members)

        def rep(x: torch.Tensor) -> torch.Tensor:
            return x.unsqueeze(0).repeat(C, *([1] * x.dim())).contiguous()

        # the search never carries the [T, B] matrices (state.py docstring)
        dummy = torch.zeros(C, 1, 1, dtype=torch.int32, device=dev)
        i32 = dict(dtype=torch.int32, device=dev)
        R = lead.R
        self.state = SearchState(
            # the placement rows live in the blocks (``rows``); these
            # zero-length placeholders keep the chain axis
            assignment=torch.zeros(C, 0, R, **i32),
            leader_slot=torch.zeros(C, 0, **i32),
            replica_disk=torch.zeros(C, 0, R, **i32),
            agg=agg.replace(**{f: rep(getattr(agg, f)) for f in BROKER_FIELDS},
                            topic_replica_count=dummy, topic_leader_count=dummy.clone()),
            part_sums=rep(part_sums),
            topic_totals=rep(topic_totals),
            mtl_sum=rep(mtl_sum),
            trd_sum=rep(trd_sum),
            cost_vec=rep(cost_vec),
            n_accepted=torch.zeros(C, **i32),
            hard_mask=tuple(GOAL_REGISTRY[n].hard for n in goal_names),
            grouped_assign=None if ga is None else rep(ga),
            grouped_leader=None if gl is None else rep(gl),
            n_prop_kind=torch.zeros(C, NUM_MOVE_KINDS, **i32),
            n_acc_kind=torch.zeros(C, NUM_MOVE_KINDS, **i32),
        )
        self.rows = [(rep(b.assignment), rep(b.leader_slot), rep(b.replica_disk))
                     for b in self.blocks]
        self.evac = evac.to(dev)
        #: the step function's keyword arguments on the lead block
        self.kw = step_kwargs(lead, cfg, goal_names, pp, engine, moves, self.group)

    def draws(self, d, per_chain: int):
        """This rank's rows of the draws made for every chain of the run
        (``per_chain`` rows a chain), on its lead device."""
        return _tree_map(lambda t: t[self.lo * per_chain:self.hi * per_chain].to(self.device), d)

    def _own(self, ps: torch.Tensor, off: int, dev):
        p = ps.to(dev).long()
        owned = (p >= off) & (p < off + self.p_local)
        return (p - off).clamp(0, self.p_local - 1), owned

    def _mirror(self, members: torch.Tensor):
        """The grouped placement mirror from the blocks: each member
        partition's owner contributes row + 1, the others 0, and the psum
        minus 1 is the row (-1 for pad entries)."""
        ga, gl = [], []
        for b, off in zip(self.blocks, self.offsets):
            mp = members.to(b.device).long()
            li = mp - off
            mine = (mp >= 0) & (li >= 0) & (li < self.p_local)
            lic = li.clamp(0, self.p_local - 1)
            ga.append(torch.where(mine[..., None], b.assignment[lic] + 1, 0))
            gl.append(torch.where(mine, b.leader_slot[lic] + 1, 0))
        return psum(ga, self.device) - 1, psum(gl, self.device) - 1

    def gather(self, state, m, chain, ps):
        from ccx_torch.search.state import PartitionView

        views = []
        for b, (ra, rl, rd), off in zip(self.blocks, self.rows, self.offsets):
            li, owned = self._own(ps, off, b.device)
            c = chain.to(b.device).long()
            views.append(_mask_view(PartitionView(
                pvalid=b.partition_valid[li] & owned,
                immovable=b.partition_immovable[li] & owned,
                topic=b.partition_topic[li],
                lead_load=b.leader_load[:, li].T,
                foll_load=b.follower_load[:, li].T,
                assign=ra[c, li],
                leader=rl[c, li],
                disk=rd[c, li],
            ), owned))
        return _psum_tree(views, self.device)

    def place(self, state, group, chain, ps, ts, write, mirror, rows, leads, disks):
        from ccx_torch.search.state import _masked_put, mirror_updates

        for b, (ra, rl, rd), off in zip(self.blocks, self.rows, self.offsets):
            dev = b.device
            li, owned = self._own(ps, off, dev)
            c = chain.to(dev).long()
            w = write.to(dev) & owned
            _masked_put(ra, (c, li), rows.to(dev), w)
            _masked_put(rl, (c, li), leads.to(dev), w)
            _masked_put(rd, (c, li), disks.to(dev), w)
        mirror_updates(state, group, chain, ps, ts, mirror, rows, leads)

    def placement(self, chain: int, device) -> tuple[torch.Tensor, ...]:
        """Chain ``chain``'s (global index) rows joined across the blocks."""
        i = chain - self.lo
        return tuple(torch.cat([r[k][i].to(device) for r in self.rows], dim=0) for k in range(3))


def _start_ranks(sm: ShardedModel, n_chains: int, *args) -> list[_ChainRank]:
    """Every chain rank's start (``_ChainRank``'s remaining arguments)."""
    per = n_chains // sm.mesh.shape[CHAINS_AXIS]
    return [_ChainRank(c, c * per, (c + 1) * per, sm, *args)
            for c in range(sm.mesh.shape[CHAINS_AXIS])]


def sharded_anneal(
    m: TensorClusterModel,
    cfg: GoalConfig = GoalConfig(),
    goal_names: tuple[str, ...] = DEFAULT_GOAL_ORDER,
    opts=None,
    mesh: Mesh | None = None,
    evac=None,
):
    """Batched SA with the model's partition axis sharded inside the
    search: the model's partition-axis tensors and the chains' placement
    rows stay in their blocks for the whole run, while chains ride the
    ``chains`` axis.

    Per proposal the block that owns the drawn partition gathers its
    PartitionView, the others contribute zeros (``_mask_view``), and one
    psum over ``parts`` gives every shard the view (batched steps: one
    stacked gather and psum per step). Every shard then scores and accepts
    identically from draws the controller's ``torch.Generator`` made once
    for all chains, in the unsharded engine's order, and only the owner
    writes the placement row. The aggregates and accumulators are
    replicated per chain and updated identically, so nothing is ever
    resynchronized.

    The run is the annealer's one driver (``annealer._run_groups``) over
    the chain ranks (``_ChainRank``), eager: with ``opts.chunk_steps > 0``
    chunk-driven through ``annealer.drive_chunks`` (one heartbeat per
    chunk, the convergence taps and the plateau exit), ``chunk_steps == 0``
    one loop (the parity reference); ``engine``, ``subSteps`` and the
    ``sa-step`` spans land under the ``sharded-anneal`` span. The
    replica-exchange ladder is not carried (``n_temps > 1`` runs flat,
    logged, as in JAX). ``opts.n_chains`` is rounded up to a multiple of
    the mesh's chain ranks (logged). ``evac`` is an optional precomputed
    hot list, as for ``anneal``.

    The result differs from ``anneal``'s on the same seed only where the
    psummed starting aggregates differ in float order. The winner is the
    lexicographic argmin across every chain; its placement is joined onto
    the input model's device and its stack re-evaluated from scratch."""
    from ccx_torch.common.tracing import TRACER
    from ccx_torch.search import annealer as sa
    from ccx_torch.search import telemetry

    if opts is None:
        opts = sa.AnnealOptions()
    if mesh is None:
        mesh = make_mesh()
    n_parts, n_chain_ranks = mesh.shape[PARTS_AXIS], mesh.shape[CHAINS_AXIS]
    if m.P % n_parts:
        raise ValueError(f"padded P={m.P} not divisible by parts={n_parts}")
    if opts.n_temps > 1:
        log.warning(
            "sharded_anneal: replica-exchange ladder (n_temps=%d) is not supported by the "
            "partition-axis-sharded engine; running flat", opts.n_temps,
        )
        opts = dataclasses.replace(opts, n_temps=1)
    C = sa.round_up_chains(opts.n_chains, n_chain_ranks, "sharded_anneal")
    if C != opts.n_chains:
        opts = dataclasses.replace(opts, n_chains=C)

    def chain_ranks(group, evac_idx, pp, engine, moves) -> list[_ChainRank]:
        needs_topic = group is not None
        sm = shard_model(m, mesh)
        struct = _struct_key(sm)
        _plan(_RUN_CACHE, ("init", mesh.key, tuple(goal_names), cfg, needs_topic, struct),
              mesh, m.P)
        ranks = costmodel.instrument("sharded-chain-init", sig=struct + (C, n_chain_ranks),
                                     device=sm.device)(_start_ranks)(
            sm, C, cfg, tuple(goal_names), group, evac_idx, pp, engine, moves)
        if opts.chunk_steps <= 0:
            _plan(_RUN_CACHE, ("run", mesh.key, tuple(goal_names), cfg, pp, engine,
                               opts.n_steps, opts.t0, opts.t1, moves, opts.p_swap_end,
                               needs_topic, struct), mesh, m.P)
        else:
            chunk = int(opts.chunk_steps)
            schedule_on = pp.allow_inter and opts.p_swap_end >= 0
            _plan(_RUN_CACHE, ("chunk", mesh.key, tuple(goal_names), cfg, pp, engine, opts.t0,
                               moves, schedule_on, needs_topic, chunk, telemetry.enabled(),
                               struct), mesh, m.P, config=(engine, moves, chunk))
        return ranks

    with TRACER.span("sharded-anneal", chains=C, steps=opts.n_steps, chunkSteps=opts.chunk_steps,
                     meshChains=n_chain_ranks, meshParts=n_parts):
        return sa._run_groups(m, cfg, goal_names, opts, evac, chain_ranks, prefix="sharded-",
                              sig_extra=(n_chain_ranks, n_parts))
