"""The computational-graph modeling language.

This mirrors the user-facing semantics of the reference implementation
(``/root/reference/src/probabilit/modeling.py:335-748``): lazy ``Node`` graphs
built by operator overloading, hashed by a unique monotonic id, sampled by
calling ``.sample(n)`` on any node.

The execution model is entirely different from the reference.  The reference
interprets the DAG node-by-node in Python, each node materialising a NumPy
array (``modeling.py:586-612``).  Here the whole DAG is *compiled*: a single
jitted XLA program maps a ``(n, d)`` quantile matrix to every requested node
output, so transform chains fuse into a handful of device kernels and the sample
axis can be sharded over a device mesh (see ``probabilit_tpu.engine``).

Each node class therefore carries two things:

* graph structure (``get_parents``, ``is_leaf``) and bookkeeping mirroring
  the reference API, and
* ``_emit(ctx)`` — how to stage this node's computation into the traced
  program, using ``jax.numpy`` ops on the parents' staged values.
"""

from __future__ import annotations

import abc
import contextlib
import copy as _copy
import functools
import heapq
import itertools
import numbers
import operator
import warnings

import jax
import jax.numpy as jnp
import numpy as np

from probabilit_tpu import config

__all__ = [
    "Node",
    "OverloadMixin",
    "Constant",
    "Transform",
    "VariadicTransform",
    "BinaryTransform",
    "UnaryTransform",
    "ScalarFunctionTransform",
    "scalar_transform",
    "python_to_prob",
    "topological_sort",
    # variadic
    "Add",
    "Multiply",
    "Max",
    "Min",
    "All",
    "Any",
    "Avg",
    "NoOp",
    # binary
    "FloorDivide",
    "Mod",
    "Divide",
    "Power",
    "Subtract",
    "Equal",
    "NotEqual",
    "LessThan",
    "LessThanOrEqual",
    "GreaterThan",
    "GreaterThanOrEqual",
    "IsClose",
    "Arctan2",
    # unary
    "Negate",
    "Abs",
    "Log",
    "Exp",
    "Floor",
    "Ceil",
    "Sign",
    "Sqrt",
    "Square",
    "Log10",
    "Sin",
    "Cos",
    "Tan",
    "Arcsin",
    "Arccos",
    "Arctan",
    "Sinh",
    "Cosh",
    "Tanh",
    "Arcsinh",
    "Arccosh",
    "Arctanh",
    "Log1p",
    "Expm1",
]


def python_to_prob(argument):
    """Convert basic Python types to probabilit node types.

    Mirrors reference ``modeling.py:272-279``.
    """
    if isinstance(argument, numbers.Number):
        return Constant(argument)
    elif isinstance(argument, Node):
        return argument
    else:
        raise ValueError(f"Type not compatible with probabilit: {argument}")


class Node(abc.ABC):
    """A node in the computational graph.

    Reference: ``modeling.py:335-680``.  Equality and hashing use the unique
    monotonically-increasing ``_id`` so nodes can live in sets; model-level
    equality must use the ``Equal`` node.
    """

    id_iter = itertools.count()

    # Bumped by every operation that can mutate an ALREADY-BUILT node's
    # sampling semantics (today: ``correlate``).  Engine-side caches of
    # per-sink static analysis (``compile.get_plan``) key on this: node
    # parents are fixed at construction, so creating new nodes can never
    # change an existing sink's plan, but a later ``correlate()`` on any
    # ancestor can.
    _mutation_epoch = 0

    # Overridden by AbstractDistribution. Avoids circular imports in
    # isinstance checks spread across the engine.
    _is_distribution = False

    def __init__(self):
        self._id = next(Node.id_iter)
        self._correlations = []

    def __eq__(self, other):
        if not isinstance(other, Node):
            return NotImplemented
        return self._id == other._id

    def __hash__(self):
        return self._id

    # ------------------------------------------------------------------
    # Graph structure
    # ------------------------------------------------------------------

    def get_parents(self):  # pragma: no cover - abstract-ish
        yield from []

    def nodes(self):
        """Yield ``self`` and all ancestors (DFS, duplicates for shared nodes).

        Mirrors reference ``modeling.py:406-423``.
        """
        queue = [self]
        while queue:
            yield (node := queue.pop())
            queue.extend(node.get_parents())

    def unique_nodes(self):
        """All unique nodes in the upstream graph (self included).

        Unlike :meth:`nodes`, uses a visited set so it terminates even on
        (invalid) cyclic graphs — letting :func:`topological_sort` report
        the cycle instead of looping forever.
        """
        seen = {self._id: self}
        stack = [self]
        while stack:
            node = stack.pop()
            for parent in node.get_parents():
                if parent._id not in seen:
                    seen[parent._id] = parent
                    stack.append(parent)
        return list(seen.values())

    def num_distribution_nodes(self):
        """Number of unique ancestor nodes that are distribution nodes.

        Uses :meth:`unique_nodes` (linear) rather than the reference's
        ``set(self.nodes())`` (modeling.py:425-429): path-multiplicity
        traversal is exponential on graphs with shared subexpressions;
        the resulting SET is identical.
        """
        return sum(1 for node in self.unique_nodes() if node._is_distribution)

    def to_graph(self):
        """Convert the computational graph to a networkx MultiDiGraph.

        Kept for reference API parity (``modeling.py:663-680``); the engine
        itself uses :func:`topological_sort` and does not need networkx.
        One divergence: each node contributes its parent edges ONCE (the
        reference iterates path-multiplicity ``nodes()``, which duplicates
        edges per path and is exponential on shared subexpressions);
        repeated parents of a single node — ``a + a`` — still yield
        parallel edges.
        """
        import networkx as nx

        nodes = self.unique_nodes()
        if len(nodes) == 1:
            G = nx.MultiDiGraph()
            G.add_node(self)
            return G
        edge_list = [
            (ancestor, node)
            for node in nodes
            for ancestor in node.get_parents()
            if not node.is_leaf
        ]
        return nx.MultiDiGraph(edge_list)

    def copy(self):
        """Copy the node and the entire upstream graph, preserving ``_id`` s
        and ``samples_``.  Mirrors reference ``modeling.py:353-404``.

        >>> from probabilit_tpu.models.distributions import Distribution
        >>> mu = Distribution("norm", loc=0, scale=1)
        >>> a = Distribution("norm", loc=mu, scale=Constant(0.5))
        >>> a2 = a.copy()
        >>> a is a2
        False
        >>> a2.kwargs["loc"] == a.kwargs["loc"]
        True
        >>> a2.kwargs["loc"] is a.kwargs["loc"]
        False
        """
        id_to_new = {}

        def update(item):
            if isinstance(item, Node):
                return id_to_new[item._id]
            return _copy.deepcopy(item)

        for node in topological_sort(self):
            copied = _copy.copy(node)
            # The shallow copy would share the original's cached plan,
            # whose topo points at the ORIGINAL nodes (same _ids, so an
            # id-keyed lookup cannot tell them apart).  Drop it.
            copied.__dict__.pop("_plan_cache", None)
            id_to_new[copied._id] = copied
            if hasattr(copied, "samples_") and copied.samples_ is not None:
                copied.samples_ = np.copy(copied.samples_)
            # Remap correlation variable references into the copied graph.
            copied._correlations = [
                (
                    [id_to_new.get(v._id, v) for v in variables],
                    np.copy(corrmat),
                )
                for (variables, corrmat) in copied._correlations
            ]
            copied._rewire(update)

        return id_to_new[self._id]

    def _rewire(self, update):
        """Update parent references after a graph copy (subclass hook)."""

    # ------------------------------------------------------------------
    # Sampling (delegates to the compiling engine)
    # ------------------------------------------------------------------

    def sample(
        self,
        size=None,
        random_state=None,
        method=None,
        correlator="imanconover",
        gc_strategy=None,
    ):
        """Sample this node; populates ``.samples_`` on ancestors.

        Same signature and semantics as reference ``modeling.py:431-493``:
        ``method`` in {None, "lhs", "halton", "sobol", "antithetic"} (the
        last is this framework's own variance-reduction extension —
        adjacent rows pair (u, 1-u), see ``ops/qmc.antithetic``),
        ``correlator`` a name
        ("imanconover"/"cholesky"/"tcopula"), a Correlator class, or a
        configured instance (e.g. ``StudentTCopula(df=3)``),
        ``gc_strategy`` None (keep everything) or a list
        of nodes to keep in addition to the sink.
        """
        from probabilit_tpu.engine import sampler

        return sampler.sample(
            self,
            size=size,
            random_state=random_state,
            method=method,
            correlator=correlator,
            gc_strategy=gc_strategy,
        )

    def sample_from_quantiles(self, quantiles, correlator="imanconover", gc_strategy=None):
        """Push a user-supplied ``(size, d)`` quantile matrix through the graph."""
        from probabilit_tpu.engine import sampler

        return sampler.sample_from_quantiles(
            self, quantiles, correlator=correlator, gc_strategy=gc_strategy
        )

    def sample_streaming(
        self, size, block_size=16_777_216, random_state=None, **kwargs
    ):
        """Sample in device-sized blocks; see ``engine.streaming``."""
        from probabilit_tpu.engine import streaming

        return streaming.sample_streaming(
            self, size, block_size=block_size, random_state=random_state, **kwargs
        )

    def estimate(self, size, block_size=16_777_216, random_state=None, **kwargs):
        """Streaming mean/var/min/max (plus ``quantiles=`` levels) at any
        sample count; O(block) memory.  See ``engine.streaming.estimate``."""
        from probabilit_tpu.engine import streaming

        return streaming.estimate(
            self, size, block_size=block_size, random_state=random_state, **kwargs
        )

    def sensitivity(self, wrt, size=65536, random_state=None, **kwargs):
        """Pathwise derivative of a statistic of this node w.r.t.
        distribution parameters, via ``jax.grad`` through the compiled
        sampling program.  See ``engine.sensitivity.sensitivity``."""
        from probabilit_tpu.engine import sensitivity as _sens

        return _sens.sensitivity(
            self, wrt, size=size, random_state=random_state, **kwargs
        )

    def sweep(self, scenarios, size=65536, random_state=None, **kwargs):
        """Statistics of this node under S parameter scenarios, evaluated
        as one vmapped compiled program with common random numbers.  See
        ``engine.sweep.sweep``."""
        from probabilit_tpu.engine import sweep as _sweep

        return _sweep.sweep(
            self, scenarios, size=size, random_state=random_state, **kwargs
        )

    def sobol_indices(self, wrt=None, size=8192, random_state=None, **kwargs):
        """First-order/total Sobol' variance decomposition of this node
        over its (independent) sampling variables, batched pick-freeze on
        the compiled program.  See ``engine.sensitivity.sobol_indices``."""
        from probabilit_tpu.engine import sensitivity as _sens

        return _sens.sobol_indices(
            self, wrt, size=size, random_state=random_state, **kwargs
        )

    def _is_initial_sampling_node(self):
        """Distribution with no Distribution ancestors (``modeling.py:616-626``)."""
        if not self._is_distribution:
            return False
        # unique_nodes, not set(nodes()): linear on shared subexpressions.
        ancestors = set(self.unique_nodes()) - {self}
        return not any(node._is_distribution for node in ancestors)

    def correlate(self, *variables, corr_mat):
        """Declare a target correlation among ancestor variables.

        Mirrors reference ``modeling.py:628-661``; validation of
        initial-sampling-node status happens at sample time.
        """
        corr_mat = np.asarray(corr_mat)
        assert corr_mat.ndim == 2
        assert corr_mat.shape[0] == corr_mat.shape[1]
        assert corr_mat.shape[0] == len(variables)
        assert len(variables) == len(set(variables))
        # unique_nodes, not set(nodes()): linear on shared subexpressions
        # (a 26-deep x = x + x chain made the reference's traversal yield
        # 2^26+ nodes at model-build time).
        nodes = set(self.unique_nodes())
        for var in variables:
            if var not in nodes:
                raise ValueError(f"{var} is not an ancestor of {self}")
        self._correlations.append((list(variables), np.copy(corr_mat)))
        Node._mutation_epoch += 1
        return self


def topological_sort(sink):
    """Deterministic topological order of ``sink``'s upstream graph.

    Parents come before children; ties are broken by node ``_id`` so results
    are reproducible without networkx.
    """
    nodes = {node._id: node for node in sink.unique_nodes()}

    children = {nid: [] for nid in nodes}  # parent_id -> [child_id]
    indegree = {nid: 0 for nid in nodes}
    for node in nodes.values():
        parent_ids = {p._id for p in node.get_parents()}
        indegree[node._id] = len(parent_ids)
        for pid in parent_ids:
            children[pid].append(node._id)

    heap = [nid for nid, deg in indegree.items() if deg == 0]
    heapq.heapify(heap)
    order = []
    while heap:
        nid = heapq.heappop(heap)
        order.append(nodes[nid])
        for cid in children[nid]:
            indegree[cid] -= 1
            if indegree[cid] == 0:
                heapq.heappush(heap, cid)
    if len(order) != len(nodes):
        raise ValueError("Graph contains a cycle; sampling requires a DAG.")
    return order


class OverloadMixin:
    """Dunder overloads building Transform nodes (``modeling.py:683-748``).

    ``==`` and ``!=`` are deliberately NOT overloaded (hashing needs them);
    use the ``Equal`` / ``NotEqual`` nodes in models.
    """

    def __add__(self, other):
        return Add(self, other)

    def __radd__(self, other):
        return Add(self, other)

    def __mul__(self, other):
        return Multiply(self, other)

    def __rmul__(self, other):
        return Multiply(self, other)

    def __floordiv__(self, other):
        return FloorDivide(self, other)

    def __rfloordiv__(self, other):
        return FloorDivide(other, self)

    def __truediv__(self, other):
        return Divide(self, other)

    def __rtruediv__(self, other):
        return Divide(other, self)

    def __mod__(self, other):
        return Mod(self, other)

    def __rmod__(self, other):
        return Mod(other, self)

    def __sub__(self, other):
        return Subtract(self, other)

    def __rsub__(self, other):
        return Subtract(other, self)

    def __pow__(self, other):
        return Power(self, other)

    def __rpow__(self, other):
        return Power(other, self)

    def __neg__(self):
        return Negate(self)

    def __abs__(self):
        return Abs(self)

    def __lt__(self, other):
        return LessThan(self, other)

    def __le__(self, other):
        return LessThanOrEqual(self, other)

    def __gt__(self, other):
        return GreaterThan(self, other)

    def __ge__(self, other):
        return GreaterThanOrEqual(self, other)


class Constant(Node, OverloadMixin):
    """A constant number, broadcast over the sample axis.

    Mirrors reference ``modeling.py:751-769`` including the dtype-preserving
    broadcast (ints stay ints) and the idempotent constructor.
    """

    is_leaf = True

    def __init__(self, value):
        self.value = value.value if isinstance(value, Constant) else value
        super().__init__()

    def get_parents(self):
        yield from []

    def __repr__(self):
        return f"{type(self).__name__}({self.value})"

    def _static_signature(self):
        return ("Constant", repr(self.value), type(self.value).__name__)

    def _emit(self, ctx):
        if isinstance(self.value, bool):
            dtype = jnp.bool_
        elif isinstance(self.value, numbers.Integral):
            dtype = config.int_dtype()
        else:
            dtype = config.float_dtype()
        return jnp.full((ctx.n,), self.value, dtype=dtype)


# =====================================================================
# Transforms
# =====================================================================


class Transform(Node, OverloadMixin, abc.ABC):
    """Arithmetic/functional operations on parent samples.

    The reference applies one NumPy ufunc per node per sampling pass
    (``modeling.py:933-1169``); here ``_emit`` stages the same op with
    ``jax.numpy`` so XLA fuses whole transform chains into single kernels.
    """

    is_leaf = False

    # Recursive repr depth cap: deep chains (1000+ node models) would
    # otherwise exhaust the Python stack whenever anything stringifies a
    # node — including error paths (the reference shares this hazard).
    _REPR_MAX_DEPTH = 50
    _repr_depth = 0

    @classmethod
    def _repr_capped(cls):
        """True once the recursive-repr budget is spent (stop recursing)."""
        return Transform._repr_depth >= Transform._REPR_MAX_DEPTH

    @classmethod
    @contextlib.contextmanager
    def _repr_frame(cls):
        """One level of recursive repr; shared by every node family."""
        Transform._repr_depth += 1
        try:
            yield
        finally:
            Transform._repr_depth -= 1

    def __repr__(self):
        if Transform._repr_capped():
            return f"{type(self).__name__}(...)"
        with Transform._repr_frame():
            parents = ", ".join(repr(parent) for parent in self.get_parents())
        return f"{type(self).__name__}({parents})"

    def _static_signature(self):
        return (type(self).__name__,)


class VariadicTransform(Transform):
    """Associative n-ary transforms: ``Add(a, b, c, ...)`` etc."""

    def __init__(self, *args):
        self.parents = tuple(python_to_prob(arg) for arg in args)
        super().__init__()

    def get_parents(self):
        yield from self.parents

    def _rewire(self, update):
        self.parents = tuple(update(p) for p in self.parents)

    def _emit(self, ctx):
        values = [ctx.value(p) for p in self.parents]
        return functools.reduce(type(self).op, values)


class Add(VariadicTransform):
    op = staticmethod(operator.add)


class Multiply(VariadicTransform):
    op = staticmethod(operator.mul)


class Max(VariadicTransform):
    op = staticmethod(jnp.maximum)


class Min(VariadicTransform):
    op = staticmethod(jnp.minimum)


class All(VariadicTransform):
    op = staticmethod(jnp.logical_and)


class Any(VariadicTransform):
    op = staticmethod(jnp.logical_or)


class Avg(VariadicTransform):
    # Avg(a, Avg(b, c)) != Avg(Avg(a, b), c), so not a reduce over an op.
    def _emit(self, ctx):
        values = [jnp.asarray(ctx.value(p), dtype=config.float_dtype()) for p in self.parents]
        return functools.reduce(operator.add, values) / len(values)


class NoOp(VariadicTransform):
    """Sample all ancestor variables, but produce no value itself.

    Like the reference (``modeling.py:993-997``), its sampled value is None.
    """

    def _emit(self, ctx):
        for p in self.parents:
            ctx.value(p)  # Force ancestors to be materialised.
        return None


class BinaryTransform(Transform):
    def __init__(self, *args):
        self.parents = tuple(python_to_prob(arg) for arg in args)
        super().__init__()

    def get_parents(self):
        yield from self.parents

    def _rewire(self, update):
        self.parents = tuple(update(p) for p in self.parents)

    def _emit(self, ctx):
        a, b = (ctx.value(p) for p in self.parents)
        return type(self).op(a, b)


class FloorDivide(BinaryTransform):
    op = staticmethod(jnp.floor_divide)


class Mod(BinaryTransform):
    op = staticmethod(jnp.mod)


class Divide(BinaryTransform):
    op = staticmethod(operator.truediv)


class Power(BinaryTransform):
    op = staticmethod(operator.pow)


class Subtract(BinaryTransform):
    op = staticmethod(operator.sub)


class Equal(BinaryTransform):
    op = staticmethod(jnp.equal)


class NotEqual(BinaryTransform):
    op = staticmethod(jnp.not_equal)


class LessThan(BinaryTransform):
    op = staticmethod(jnp.less)


class LessThanOrEqual(BinaryTransform):
    op = staticmethod(jnp.less_equal)


class GreaterThan(BinaryTransform):
    op = staticmethod(jnp.greater)


class GreaterThanOrEqual(BinaryTransform):
    op = staticmethod(jnp.greater_equal)


class IsClose(BinaryTransform):
    op = staticmethod(jnp.isclose)


class Arctan2(BinaryTransform):
    op = staticmethod(jnp.arctan2)


class UnaryTransform(Transform):
    def __init__(self, arg):
        self.parent = python_to_prob(arg)
        super().__init__()

    def get_parents(self):
        yield self.parent

    def _rewire(self, update):
        self.parent = update(self.parent)

    def _emit(self, ctx):
        return type(self).op(ctx.value(self.parent))


class Negate(UnaryTransform):
    op = staticmethod(operator.neg)


class Abs(UnaryTransform):
    op = staticmethod(jnp.abs)


class Log(UnaryTransform):
    op = staticmethod(jnp.log)


class Exp(UnaryTransform):
    op = staticmethod(jnp.exp)


class Floor(UnaryTransform):
    op = staticmethod(jnp.floor)


class Ceil(UnaryTransform):
    op = staticmethod(jnp.ceil)


class Sign(UnaryTransform):
    op = staticmethod(jnp.sign)


class Sqrt(UnaryTransform):
    op = staticmethod(jnp.sqrt)


class Square(UnaryTransform):
    op = staticmethod(jnp.square)


class Log10(UnaryTransform):
    op = staticmethod(jnp.log10)


class Sin(UnaryTransform):
    op = staticmethod(jnp.sin)


class Cos(UnaryTransform):
    op = staticmethod(jnp.cos)


class Tan(UnaryTransform):
    op = staticmethod(jnp.tan)


class Arcsin(UnaryTransform):
    op = staticmethod(jnp.arcsin)


class Arccos(UnaryTransform):
    op = staticmethod(jnp.arccos)


class Arctan(UnaryTransform):
    op = staticmethod(jnp.arctan)


class Sinh(UnaryTransform):
    op = staticmethod(jnp.sinh)


class Cosh(UnaryTransform):
    op = staticmethod(jnp.cosh)


class Tanh(UnaryTransform):
    op = staticmethod(jnp.tanh)


class Arcsinh(UnaryTransform):
    op = staticmethod(jnp.arcsinh)


class Arccosh(UnaryTransform):
    op = staticmethod(jnp.arccosh)


class Arctanh(UnaryTransform):
    op = staticmethod(jnp.arctanh)


class Log1p(UnaryTransform):
    """log(1 + x), exact for |x| near 0 (framework extension: the
    importance-tilting weights need deep-tail quantile precision that a
    literal ``Log(1 + x)`` loses to float rounding)."""

    op = staticmethod(jnp.log1p)


class Expm1(UnaryTransform):
    """exp(x) - 1, exact for |x| near 0 (framework extension, paired
    with ``Log1p``)."""

    op = staticmethod(jnp.expm1)


class ScalarFunctionTransform(Transform):
    """Monte-Carlo through an arbitrary scalar Python function.

    The reference loops sample-by-sample in Python (``modeling.py:1172-1212``,
    its slowest construct).  Here we first try to ``jax.vmap`` the function —
    if it traces, it compiles and fuses with the rest of the program (orders
    of magnitude faster).  Functions with data-dependent Python control flow
    fall back to a host callback that reproduces the reference loop.
    """

    def __init__(self, func, args, kwargs, dtype=None):
        self.func = func
        self.args = args
        self.kwargs = kwargs
        self.dtype = dtype
        super().__init__()

    def get_parents(self):
        for arg in self.args + tuple(self.kwargs.values()):
            if isinstance(arg, Node):
                yield arg

    def _rewire(self, update):
        # update() on EVERY item, Node or not: non-Node arguments are
        # deep-copied, matching reference copy semantics (modeling.py:
        # 371-394 — a mutable arg must not stay aliased between a graph
        # and its copy).
        self.args = tuple(update(a) for a in self.args)
        self.kwargs = {k: update(v) for k, v in self.kwargs.items()}

    @staticmethod
    def _static_arg_token(v):
        """Stable, collision-resistant token for a non-Node argument.

        repr() alone is wrong for two classes of values: numpy truncates
        array reprs past 1000 elements (different tables would collide),
        and default object reprs embed memory addresses (the checkpoint
        fingerprint would differ across processes for the same graph).
        """
        if isinstance(v, Node):
            return "<node>"
        if isinstance(v, np.ndarray):
            return ("ndarray", v.shape, str(v.dtype), v.tobytes())
        r = repr(v)
        if " at 0x" in r:
            return ("object", type(v).__qualname__)
        return r

    def _static_signature(self):
        # Static (non-Node) arguments and the Node/static layout are part of
        # the structure: st(x, 2) and st(x, 3), or f(x, node) vs f(node, x),
        # compute different functions and must not share a signature (the
        # checkpoint fingerprint and program cache both key on this).
        arg_layout = tuple(self._static_arg_token(a) for a in self.args)
        kwarg_layout = tuple(
            (k, self._static_arg_token(v)) for k, v in sorted(self.kwargs.items())
        )
        return (
            "ScalarFunctionTransform",
            id(self.func),
            str(self.dtype),
            arg_layout,
            kwarg_layout,
        )

    def _emit(self, ctx):
        node_args = [a for a in self.args if isinstance(a, Node)]
        node_kwargs = {k: v for k, v in self.kwargs.items() if isinstance(v, Node)}
        arrays = [ctx.value(a) for a in node_args] + [
            ctx.value(v) for v in node_kwargs.values()
        ]

        def call_scalar(*scalars):
            it = iter(scalars)
            args = [next(it) if isinstance(a, Node) else a for a in self.args]
            kwargs = {
                k: (next(it) if isinstance(v, Node) else v)
                for k, v in self.kwargs.items()
            }
            return self.func(*args, **kwargs)

        if not arrays:
            # Constant-only arguments (no Node inputs): vmap would reject
            # the zero-array call, and the reference's per-sample loop
            # just repeats one value — evaluate once and broadcast.
            out_dtype = (
                self.dtype if self.dtype is not None else config.float_dtype()
            )
            value = jnp.asarray(call_scalar(), dtype=out_dtype)
            return jnp.broadcast_to(value, (ctx.n,))

        # Fast path: the function is jax-traceable -> vectorise and compile.
        # Only trace-time incompatibilities (a Tracer leaking into numpy /
        # math / external code raises TracerError or TypeError, a missing
        # jax equivalent raises NotImplementedError) select the slow host
        # loop; genuine bugs in the user function (shape mismatches,
        # ValueError, ...) surface instead of silently degrading 1000x.
        try:
            return jax.vmap(call_scalar)(*arrays)
        except (jax.errors.TracerArrayConversionError, jax.errors.TracerBoolConversionError, TypeError, NotImplementedError) as exc:
            fname = getattr(self.func, "__name__", self.func)
            if isinstance(
                exc,
                (
                    jax.errors.TracerArrayConversionError,
                    jax.errors.TracerBoolConversionError,
                ),
            ):
                detail = "is not jax-traceable"
            else:
                # A plain TypeError can mean EITHER an untraceable function
                # OR a genuine bug; surface the message so a bug is visible
                # here, not first as an opaque runtime callback failure.
                detail = (
                    "raised at trace time "
                    f"({type(exc).__name__}: {str(exc)[:200]}) — if this "
                    "points at a bug in the function, the host loop will "
                    "raise it again at sampling time"
                )
            warnings.warn(
                f"scalar_transform function {fname!r} {detail}; falling back "
                "to the per-sample host loop (orders of magnitude slower).",
                stacklevel=2,
            )

        # Fallback: host callback running the reference-style Python loop.
        out_dtype = self.dtype if self.dtype is not None else config.np_float_dtype()

        def host_loop(*arrs):
            rows = zip(*arrs) if arrs else itertools.repeat((), ctx.n)
            return np.array(
                [call_scalar(*row) for _, row in zip(range(ctx.n), rows)],
                dtype=out_dtype,
            )

        result_shape = jax.ShapeDtypeStruct((ctx.n,), out_dtype)
        return jax.pure_callback(host_loop, result_shape, *arrays, vmap_method="sequential")


def scalar_transform(func=None, *, dtype=None):
    """Decorator turning ``f(scalars) -> scalar`` into a graph node factory.

    Mirrors reference ``modeling.py:1204-1212``; the extra ``dtype`` keyword
    controls the output dtype of the host-callback fallback path.
    """

    def decorate(f):
        @functools.wraps(f)
        def transformed_function(*args, **kwargs):
            return ScalarFunctionTransform(f, args, kwargs, dtype=dtype)

        return transformed_function

    if func is None:
        return decorate
    return decorate(func)
