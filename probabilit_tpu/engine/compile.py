"""Graph compiler: DAG -> one jitted XLA sampling program.

The reference interprets the graph node-by-node in Python, with three phases
(``modeling.py:495-614``): (1) sample initial sampling nodes (ISNs) from
quantile columns, (2) induce declared correlations on the ISN matrix,
(3) propagate through transforms in topological order, garbage-collecting
``samples_`` arrays as reference counts hit zero.

Here all three phases are staged into a single traced function
``program(quantiles) -> (outputs, finite_flags)`` and compiled once per
graph structure:

* transforms fuse into a handful of device kernels (no per-node dispatch);
* the correlator (Iman-Conover / Cholesky) is spliced into the same
  program, so its sorts/matmuls fuse with sampling;
* the garbage-collection strategy becomes *output selection*: nodes not
  kept are simply not returned, and XLA's dead-code elimination ensures
  their intermediates never materialise in HBM — strictly stronger than
  the reference's reference-counting deleter (``garbage_collector.py``);
* non-finite detection (``modeling.py:600-606``) compiles to one scalar
  ``all(isfinite)`` flag per kept node, checked on host after the run.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from probabilit_tpu import config
from probabilit_tpu.models import graph as _graph
from probabilit_tpu.ops import correlation as _correlation
from probabilit_tpu.ops import ncm as _ncm
from probabilit_tpu.utils import build_corrmat

CORRELATOR_MAP = {
    "imanconover": _correlation.ImanConover,
    "cholesky": _correlation.Cholesky,
    # Extension beyond the reference map (modeling.py:505-507): the
    # t-copula correlator at its default df; parameterized use passes an
    # instance, e.g. sample(correlator=StudentTCopula(df=3)).
    "tcopula": _correlation.StudentTCopula,
}

_NCM_CACHE = {}


class EmitContext:
    """Tracing context handed to ``Node._emit``: memoised lazy evaluation.

    ``gen_key`` is the program's in-trace PRNG key when the engine
    generates the uniforms itself (``method=None``) and ``None`` when an
    explicit quantile matrix drives the run (QMC methods,
    ``sample_from_quantiles``).  Multi-column nodes (path processes)
    branch on it: with a quantile matrix they consume their own slab of
    columns (``slab``), otherwise they draw from a column-seeded key.
    """

    def __init__(self, n, columns, quantiles=None, slabs=None, gen_key=None):
        self.n = n
        self._columns = columns  # node_id -> traced quantile column
        self._quantiles = quantiles  # full (n, d_total) matrix, or None
        self._slabs = slabs or {}  # node_id -> (start, width)
        self.gen_key = gen_key
        self._values = {}

    def value(self, node):
        nid = node._id
        if nid not in self._values:
            self._values[nid] = node._emit(self)
        return self._values[nid]

    def set_value(self, node, value):
        self._values[node._id] = value

    def column(self, node):
        return self._columns[node._id]

    def slab(self, node):
        """The node's ``(n, _q_width)`` quantile slab (quantile mode only).

        Dimension 0 is the node's OWN scalar column (the same one that
        seeds its PRNG key under ``method=None``), so the node's
        best-placed QMC dimension drives its dominant feature and no
        quantile column is ever generated-but-unconsumed; the remaining
        ``_q_width - 1`` driver columns live in the extra block past the
        scalar columns.
        """
        own, start, extra = self._slabs[node._id]
        col = jax.lax.slice_in_dim(self._quantiles, own, own + 1, axis=1)
        if not extra:
            return col
        rest = jax.lax.slice_in_dim(self._quantiles, start, start + extra, axis=1)
        return jnp.concatenate([col, rest], axis=1)


class Plan:
    """Static analysis of a graph: topo order, column map, correlations."""

    def __init__(self, sink):
        self.sink = sink
        self.topo = _graph.topological_sort(sink)

        # One pass over the topo order: which nodes have distribution
        # ancestors (an ISN is a distribution without any).
        has_dist_ancestor = {}
        for node in self.topo:
            parents = list(node.get_parents())
            has_dist_ancestor[node._id] = any(
                p._is_distribution or has_dist_ancestor[p._id] for p in parents
            )
        self.isns = sorted(
            (
                n
                for n in self.topo
                if n._is_distribution and not has_dist_ancestor[n._id]
            ),
            key=lambda n: n._id,
        )

        # Column assignment mirrors the reference's consumption order
        # (``modeling.py:510-538, 586-592``): ISNs sorted by _id first,
        # then composite distribution nodes in topological order.
        composite = [
            n for n in self.topo if n._is_distribution and has_dist_ancestor[n._id]
        ]
        self.dist_nodes = self.isns + composite
        self.col_of = {n._id: i for i, n in enumerate(self.dist_nodes)}
        self.d = len(self.dist_nodes)

        # Multi-column nodes (path processes declare ``_q_width``) own a
        # SLAB of quantile columns consumed in quantile mode (QMC methods
        # / ``sample_from_quantiles``): dimension 0 is the node's own
        # scalar column, the remaining ``_q_width - 1`` drivers sit in a
        # contiguous extra block past the scalar columns (``d_total`` is
        # the full matrix width; a width-1 node consumes just its own
        # column).  The engine-generated PRNG path (``rng_inline``) never
        # materialises the extras — those programs stay (n, d).
        self.slab_of = {}
        off = self.d
        for node in self.dist_nodes:
            width = getattr(node, "_q_width", None)
            if width is None:
                continue
            extra = max(int(width) - 1, 0)
            self.slab_of[node._id] = (self.col_of[node._id], off, extra)
            off += extra
        self.d_total = off

        # Topo-ordered prefix needed before correlation induction: the ISNs
        # and their (Constant/Transform) ancestors.  Evaluating strictly in
        # topological order keeps the emitter's memoised recursion at
        # depth 1, so arbitrarily deep graphs trace without hitting
        # Python's recursion limit.
        isn_ids = {n._id for n in self.isns}
        in_prefix = set()
        stack = list(self.isns)
        while stack:
            node = stack.pop()
            if node._id in in_prefix:
                continue
            in_prefix.add(node._id)
            stack.extend(node.get_parents())
        self.pre_topo = [n for n in self.topo if n._id in in_prefix or n._id in isn_ids]

        self._analyze_correlations()

        self._signature = None

        # Host-side output finalizers (e.g. string-valued categorical
        # gathers) are a static property of the node type.
        self.finalizers = {}
        for node in self.topo:
            fin = getattr(node, "_host_finalizer", None)
            if fin is not None:
                fn = fin()
                if fn is not None:
                    self.finalizers[node._id] = fn

    def _analyze_correlations(self):
        """Collect and validate declared correlations (``modeling.py:540-574``)."""
        correlations = []
        for node in self.topo:
            correlations.extend(node._correlations)

        isn_set = set(self.isns)
        for variables, _ in correlations:
            for variable in variables:
                if variable not in isn_set:
                    raise ValueError(f"Cannot correlate variable: {variable}")
                if getattr(variable, "_vector_valued", False):
                    # Copula/path nodes produce (n, d)/(n, steps) arrays;
                    # the correlator stacks 1-D sample vectors.  Without
                    # this guard the shape mismatch surfaces as a cryptic
                    # trace error deep in the correlator.
                    raise ValueError(
                        f"Cannot correlate vector-valued node {variable!r}; "
                        "correlate scalar marginals/functionals of it "
                        "instead."
                    )

        import itertools

        variable_sets = [set(variables) for (variables, _) in correlations]
        for vars1, vars2 in itertools.combinations(variable_sets, 2):
            common = vars1.intersection(vars2)
            if len(common) > 1:
                raise ValueError(f"Correlations specified more than once: {common}")

        if not correlations:
            self.corr_vars = []
            self.corr_matrix = None
            return

        all_variables = sorted(
            set().union(*variable_sets), key=lambda n: n._id
        )
        var_to_int = {v: i for i, v in enumerate(all_variables)}
        indexed = [
            (tuple(var_to_int[var] for var in variables), corrmat)
            for (variables, corrmat) in correlations
        ]
        self.corr_vars = all_variables
        raw = build_corrmat(indexed)
        # Cache the (host, O(K^3)) nearest-correlation-matrix solve:
        # distinct sinks (or invalidated plans) often share target blocks.
        cache_key = raw.tobytes()
        cached = _NCM_CACHE.get(cache_key)
        if cached is None:
            cached = _ncm.nearest_correlation_matrix(raw)
            if len(_NCM_CACHE) > 64:
                _NCM_CACHE.pop(next(iter(_NCM_CACHE)))
            _NCM_CACHE[cache_key] = cached
        self.corr_matrix = cached

    def columns_of(self, node):
        """Every quantile column the node's randomness consumes.

        Scalar nodes: their one column.  Slab nodes (paths): the scalar
        column plus the extra driver block — pick-freeze designs
        (engine/sensitivity.py) must swap ALL of them together to
        attribute the node's full variance contribution.
        """
        nid = node._id
        cols = [self.col_of[nid]]
        if nid in self.slab_of:
            _, start, extra = self.slab_of[nid]
            cols.extend(range(start, start + extra))
        return tuple(cols)

    def signature(self):
        # Memoised: a Plan is immutable once built (get_plan invalidates
        # the whole Plan on graph mutation), and re-tupling a 12k-node
        # graph per program-cache lookup is O(graph) Python on every call.
        sig = self._signature
        if sig is None:
            rows = []
            for node in self.topo:
                parent_ids = tuple(p._id for p in node.get_parents())
                rows.append((node._id, node._static_signature(), parent_ids))
            corr_sig = (
                None
                if self.corr_matrix is None
                else (
                    tuple(v._id for v in self.corr_vars),
                    self.corr_matrix.tobytes(),
                )
            )
            sig = self._signature = (tuple(rows), self.sink._id, corr_sig)
        return sig


def get_plan(sink):
    """Build (or fetch) the Plan for ``sink``, cached on the node itself.

    Node parent sets are fixed at construction, so a sink's ancestor
    subgraph can only change through explicit mutation — today just
    ``correlate()``, which bumps ``Node._mutation_epoch``.  The cache
    entry lives on the sink (dies with it, no global registry) and is
    dropped by ``Node.copy`` (the copy shares ``_id`` s with the
    original, so it must re-analyze).  At the proven 12k-node scale this
    turns the per-``sample()`` Python overhead from O(graph) re-analysis
    into one attribute check.
    """
    cached = getattr(sink, "_plan_cache", None)
    if cached is not None:
        epoch, plan = cached
        if epoch == _graph.Node._mutation_epoch:
            return plan
    plan = Plan(sink)
    sink._plan_cache = (_graph.Node._mutation_epoch, plan)
    return plan


def resolve_correlator(correlator):
    """Name -> class from the map; classes and INSTANCES pass through.

    Instances carry configuration (``StudentTCopula(df=3)``,
    ``ImanConover(ties="ordinal")``); ``correlator_token`` folds that
    configuration into program-cache keys.
    """
    if isinstance(correlator, str):
        return CORRELATOR_MAP[correlator.lower()]
    return correlator


def correlator_token(correlator_cls):
    """Hashable cache identity of a resolved correlator (class or instance)."""
    if isinstance(correlator_cls, _correlation.Correlator):
        return correlator_cls._cache_token()
    return getattr(correlator_cls, "__qualname__", str(correlator_cls))


def instantiate_correlator(correlator_cls):
    """A usable instance from a resolved correlator (class or instance)."""
    if isinstance(correlator_cls, _correlation.Correlator):
        return correlator_cls
    return correlator_cls()


def _active_mesh_key():
    from probabilit_tpu.parallel import mesh as _par_mesh

    m = _par_mesh.current_mesh()
    return None if m is None else (m.axis_names, m.devices.shape, str(m.devices.flat[0]))


def _generatable(var):
    """Can this variable's sorted marginal be generated directly?

    True when the node's sampler is a monotone scalar inverse-CDF (so
    sorted uniforms map to sorted samples).
    """
    import numpy as np

    from probabilit_tpu.models.distributions import (
        CumulativeDistribution,
        Distribution,
        DiscreteDistribution,
        EmpiricalDistribution,
        _scipy_is_multivariate,
    )

    if isinstance(var, Distribution):
        try:
            return not _scipy_is_multivariate(var.distr)
        except AttributeError:
            return False
    if isinstance(var, (EmpiricalDistribution, CumulativeDistribution)):
        return True
    if isinstance(var, DiscreteDistribution):
        return np.issubdtype(var.values.dtype, np.number)
    return False


def recolor_eligible(plan, correlator_cls):
    """Can generated sampling induce this plan's correlations sort-free?

    True when the plan declares correlations, the correlator exposes
    ``_recolor_scores`` (Gaussian-copula score recoloring), and every
    correlated variable is ``_generatable`` (monotone inverse-CDF).
    This is the ONE eligibility rule shared by ``get_program``'s
    generated fast path, streamed correlated ``estimate()``, streamed
    gradients (``engine.sensitivity``) and streamed sweeps
    (``engine.sweep``) — single-sourced so the entry points can never
    disagree on which graphs recolor, and their streams never
    desynchronise.
    """
    return (
        plan.corr_matrix is not None
        and hasattr(correlator_cls, "_recolor_scores")
        and all(_generatable(v) for v in plan.corr_vars)
    )


_PROGRAM_CACHE = {}
_CACHE_LIMIT = 128

# Keep-sets wider than this get a host-side finite check instead of
# in-program flags (see the note in the program body).
_INLINE_FINITE_CHECK_MAX = 64


def build_body(plan, correlator_cls, keep_ids, check_finite=True, generated_ok=False):
    """Build the traced 3-phase sampling body for ``plan``.

    Returns ``body(quantiles, gen_key=None) -> (outputs, finite_flag)``.
    Shared by ``get_program`` (which jits it, optionally behind in-program
    RNG) and ``engine/sensitivity`` (which differentiates through it with
    distribution parameters swapped for traced scalars).
    """
    corr_matrix = plan.corr_matrix
    corr_vars = list(plan.corr_vars)
    topo = list(plan.topo)
    pre_topo = list(plan.pre_topo)
    col_of = dict(plan.col_of)
    slab_of = dict(plan.slab_of)
    sink = plan.sink
    keep_ids = frozenset(keep_ids)
    corr_var_ids = frozenset(v._id for v in corr_vars)

    def body(quantiles, gen_key=None):
        n = quantiles.shape[0]
        if corr_matrix is not None and n <= len(corr_vars):
            # Static at trace time; mirrors the reference's eager guard
            # (correlation.py:193-195) instead of surfacing a downstream
            # NaN-Cholesky as a generic non-finite error.
            raise ValueError(
                "Inducing correlations needs more observations than "
                "variables (rows > columns); X has shape "
                f"({n}, {len(corr_vars)})."
            )
        columns = {nid: quantiles[:, col] for nid, col in col_of.items()}
        ctx = EmitContext(
            n=n,
            columns=columns,
            quantiles=quantiles,
            slabs=slab_of,
            gen_key=gen_key,
        )
        fast = generated_ok and gen_key is not None

        # Phase 1: initial sampling nodes and their Constant/Transform
        # parameter ancestors, in topological order (bounded recursion).
        for node in pre_topo:
            if fast and node._id in corr_var_ids:
                continue  # Produced by the generated correlator below.
            ctx.value(node)

        # Phase 2: correlation induction on the declared variables.
        # Variables stack on the leading axis ((K, N), lane-aligned) so the
        # Iman-Conover sort pipeline runs without transposes.
        if corr_matrix is not None:
            instance = instantiate_correlator(correlator_cls).set_target(corr_matrix)
            # Mixed-score copulas (StudentTCopula) draw a per-observation
            # mixing variable: from the run's own key when the engine
            # generates the samples, else seeded by the first correlated
            # column's leading quantile bits — the same
            # randomness-from-quantiles contract the reference uses for
            # multivariate rvs fallbacks (modeling.py:808-812).
            w_key = None
            if not getattr(type(instance), "gaussian_scores", True):
                if gen_key is not None:
                    w_key = jax.random.fold_in(gen_key, 0x7C09)
                else:
                    u00 = quantiles[0, col_of[corr_vars[0]._id]]
                    bits = jax.lax.bitcast_convert_type(
                        u00.astype(jnp.float32), jnp.uint32
                    )
                    w_key = jax.random.fold_in(
                        jax.random.PRNGKey(getattr(instance, "seed", 0)), bits
                    )
            if fast:
                from probabilit_tpu.ops import special as _special
                from probabilit_tpu.ops.qmc import clamp_open_unit

                dtype = config.float_dtype()
                z = jnp.stack(
                    [
                        _special.ndtri_fast(ctx.column(v).astype(dtype))
                        for v in corr_vars
                    ],
                    axis=0,
                )
                # Sort-free Gaussian-copula form of the generated
                # Iman-Conover: recolor the normal scores to the target
                # correlation (with the 1982 empirical-decorrelation
                # variance reduction), then push each score row back
                # through Phi and the variable's own inverse CDF.  The
                # final ranks are IDENTICAL to the former two-sort
                # variant (rank(ppf(ndtr(y))) == rank(y) == the rank the
                # sorted marginal was placed at), but marginals become
                # exact iid quantile transforms instead of an order-
                # statistics multiset, no sorts run, and under a mesh
                # the whole step is elementwise + one psum'd (K,K) Gram —
                # no all-gathers.
                y = instance._recolor_scores(z)
                from probabilit_tpu.ops import ppf as _ppf

                gaussian = getattr(type(instance), "gaussian_scores", True)
                if not gaussian:
                    # Mixed-score copula: one shared mixing draw, then
                    # ONE lax.map body converts score rows to uniforms
                    # (see ops/correlation._copula_uniforms for the
                    # compile-time and HBM rationale).  score_emit's
                    # closed-form ppf(Phi(y)) shortcuts assume Gaussian
                    # scores, so they are skipped wholesale.
                    u_rows = clamp_open_unit(instance._copula_uniforms(y, w_key))
                for i, var in enumerate(corr_vars):
                    val_i = None
                    if gaussian:
                        # Score-linear families (norm/lognorm) evaluate
                        # ppf(Phi(y)) in closed form from y itself — exact
                        # where the polynomial roundtrip drifts in the tails.
                        val_i = _ppf.score_emit(var, y[i], ctx)
                    if val_i is None:
                        u_i = (
                            clamp_open_unit(_special.ndtr_fast(y[i]))
                            if gaussian
                            else u_rows[i]
                        )
                        saved = ctx._columns[var._id]
                        ctx._columns[var._id] = u_i
                        val_i = var._emit(ctx)
                        ctx._columns[var._id] = saved
                    ctx.set_value(var, val_i)
            else:
                XT = jnp.stack([ctx.value(v) for v in corr_vars], axis=0)
                XT = XT.astype(config.float_dtype())
                if hasattr(instance, "_apply_rows"):
                    X_corr_T = instance._apply_rows(XT, w_key=w_key)
                else:
                    X_corr_T = instance._apply(XT.T).T
                for i, var in enumerate(corr_vars):
                    ctx.set_value(var, X_corr_T[i])

        # Phase 3: propagate in topological order (every node evaluates
        # with its parents already memoised — depth-1 recursion, so deep
        # graphs trace fine); materialise only the kept outputs, XLA
        # dead-code-eliminates the rest.
        outputs = {}
        for node in topo:
            value = ctx.value(node)
            if node._id in keep_ids:
                outputs[node._id] = value
        ctx.value(sink)

        # One fused scalar over the kept inexact outputs. Only emitted for
        # narrow keep-sets: hundreds of small reduction ops measurably blow
        # up XLA compile time (a 1200-output keep-all graph compiled 3x
        # slower with per-node flags), so wide keep-sets are checked
        # host-side by the sampler instead (they are small-n by nature —
        # keeping every node's samples at large n is host-memory-bound
        # anyway). The offending node is identified host-side either way.
        flag = None
        if check_finite and len(keep_ids) <= _INLINE_FINITE_CHECK_MAX:
            for value in outputs.values():
                if value is None or not jnp.issubdtype(value.dtype, jnp.inexact):
                    continue
                ok = jnp.all(jnp.isfinite(value))
                flag = ok if flag is None else jnp.logical_and(flag, ok)
        return outputs, flag

    return body


def get_program(plan, correlator, keep_ids, check_finite=True, rng_inline_n=None):
    """Build (or fetch) the jitted sampling program for this plan.

    With ``rng_inline_n=None`` the program takes a ``(n, d)`` quantile
    matrix.  With ``rng_inline_n=n`` it takes a PRNG *key* and generates
    the uniforms inside the traced program — the counter-based bits fuse
    directly into the ppf kernels, so no quantile buffer ever materialises
    in HBM (the memory- and bandwidth-optimal path for ``method=None``).
    """
    correlator_cls = resolve_correlator(correlator)
    key = (
        plan.signature(),
        correlator_token(correlator_cls),
        tuple(sorted(keep_ids)),
        bool(check_finite),
        jnp.dtype(config.float_dtype()).name,
        rng_inline_n,
        _active_mesh_key(),
    )
    cached = _PROGRAM_CACHE.get(key)
    if cached is not None:
        return cached

    d = plan.d

    # The two-sort "generated" Iman-Conover variant applies when the engine
    # itself draws the samples (a PRNG key is available) and every
    # correlated variable has a monotone inverse-CDF: sorted marginals come
    # from uniform order statistics instead of a data sort, and the
    # variables' own quantile columns provide the normal scores.
    generated_ok = rng_inline_n is not None and recolor_eligible(
        plan, correlator_cls
    )
    body = build_body(
        plan,
        correlator_cls,
        keep_ids,
        check_finite=check_finite,
        generated_ok=generated_ok,
    )

    if rng_inline_n is None:
        program = body
    else:
        from probabilit_tpu.parallel import mesh as _par_mesh

        sharding = _par_mesh.sample_sharding(ndim=2)

        from probabilit_tpu.ops.qmc import clamp_open_unit

        def program(rng_key):
            gen_key = jax.random.fold_in(rng_key, 0x0D0E5)
            quantiles = clamp_open_unit(
                jax.random.uniform(
                    rng_key, (rng_inline_n, d), dtype=config.float_dtype()
                )
            )
            if sharding is not None:
                quantiles = jax.lax.with_sharding_constraint(quantiles, sharding)
            return body(quantiles, gen_key=gen_key)

    compiled = jax.jit(program)
    if len(_PROGRAM_CACHE) >= _CACHE_LIMIT:
        _PROGRAM_CACHE.pop(next(iter(_PROGRAM_CACHE)))
    _PROGRAM_CACHE[key] = compiled
    return compiled
