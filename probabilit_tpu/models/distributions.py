"""Distribution node types for the modeling language.

Mirrors the reference node classes (``modeling.py:772-927, 1215-1264``) with
compiled sampling: each node stages an inverse-CDF kernel from
``probabilit_tpu.ops.ppf`` into the compiled program instead of calling
scipy's ``.ppf`` per node (``modeling.py:805-812``).
"""

from __future__ import annotations

import abc
import functools

import jax.numpy as jnp
import numpy as np

from probabilit_tpu import config
from probabilit_tpu.models.graph import Node, OverloadMixin, Transform
from probabilit_tpu.ops import ppf

__all__ = [
    "AbstractDistribution",
    "Distribution",
    "EmpiricalDistribution",
    "CumulativeDistribution",
    "DiscreteDistribution",
    "MarginalDistribution",
    "MultivariateDistribution",
    "CopulaDistribution",
    "EllipticalCopulaDistribution",
    "EmpiricalCopulaDistribution",
    "QuantileTransform",
]


@functools.lru_cache(maxsize=None)
def _scipy_is_multivariate(name):
    return ppf.is_multivariate(name)


class AbstractDistribution(Node, OverloadMixin, abc.ABC):
    """Base class for all sampling nodes; consumes one quantile column."""

    _is_distribution = True


class Distribution(AbstractDistribution):
    """A parametric distribution addressed by its scipy.stats name.

    Parameters may be numbers or other nodes (composite distributions).
    Mirrors reference ``modeling.py:776-823``; sampling resolves a native
    XLA ppf kernel (``ops/ppf.py``), falling back to a host scipy callback
    for unregistered names.

    >>> Distribution("norm", loc=5, scale=1)
    Distribution("norm", loc=5, scale=1)
    """

    def __init__(self, distr, *args, **kwargs):
        self.distr = distr
        self.args = args
        self.kwargs = kwargs
        super().__init__()

    def __repr__(self):
        from probabilit_tpu.models.graph import Transform

        # Shares Transform's depth cap: composite parameters recurse, and
        # deep chains must not exhaust the stack when stringified.
        if Transform._repr_capped():
            return f'{type(self).__name__}("{self.distr}", ...)'
        with Transform._repr_frame():
            args = ", ".join(repr(arg) for arg in self.args)
            kwargs = ", ".join(f"{k}={repr(v)}" for (k, v) in self.kwargs.items())
        out = f'{type(self).__name__}("{self.distr}"'
        if args:
            out += f", {args}"
        if kwargs:
            out += f", {kwargs}"
        return out + ")"

    def get_parents(self):
        for arg in self.args + tuple(self.kwargs.values()):
            if isinstance(arg, Node):
                yield arg

    @property
    def is_leaf(self):
        return list(self.get_parents()) == []

    def _rewire(self, update):
        # update() on EVERY item: non-Node arguments are deep-copied,
        # matching reference copy semantics (modeling.py:371-394).
        self.args = tuple(update(a) for a in self.args)
        self.kwargs = {k: update(v) for k, v in self.kwargs.items()}

    def _static_signature(self):
        sig_args = tuple(
            "<node>" if isinstance(a, Node) else repr(a) for a in self.args
        )
        sig_kwargs = tuple(
            (k, "<node>" if isinstance(v, Node) else repr(v))
            for k, v in sorted(self.kwargs.items())
        )
        return ("Distribution", self.distr, sig_args, sig_kwargs)

    def _mv_dim(self):
        """Event dimension of a multivariate distribution (probed once)."""
        if not hasattr(self, "_mv_dim_cache"):
            import scipy.stats as sps

            frozen = getattr(sps, self.distr)(*self.args, **self.kwargs)
            draw = np.atleast_2d(np.asarray(frozen.rvs(size=1, random_state=0)))
            self._mv_dim_cache = draw.shape[-1]
        return self._mv_dim_cache

    def _emit(self, ctx):
        q = ctx.column(self)

        def unpack(arg):
            return ctx.value(arg) if isinstance(arg, Node) else arg

        args = tuple(unpack(a) for a in self.args)
        kwargs = {k: unpack(v) for k, v in self.kwargs.items()}

        if _scipy_is_multivariate(self.distr):
            # Multivariate leaf, seeded from q[0] like the reference
            # (``modeling.py:808-812``).  Common families sample natively
            # on device; anything else goes through a scipy host callback.
            from probabilit_tpu.ops import multivariate as mv

            shape = (ctx.n, self._mv_dim())
            native = mv.lookup(self.distr)
            if native is not None:
                return native(q, shape, *args, **kwargs)
            return ppf.scipy_fallback_rvs(self.distr, q, shape, *args, **kwargs)

        return ppf.call(self.distr, q, *args, **kwargs)


class EmpiricalDistribution(AbstractDistribution):
    """Inverse-CDF sampling from observed data; wraps ``np.quantile``.

    Reference ``modeling.py:825-844``.  The default linear interpolation
    compiles to a fused ``interp`` over the sorted data (device resident);
    other ``method=`` values use an exact host ``np.quantile`` callback.
    """

    is_leaf = True

    def __init__(self, data, **kwargs):
        self.data = np.array(data)
        self.kwargs = kwargs
        super().__init__()

    def __repr__(self):
        return f"{type(self).__name__}()"

    def get_parents(self):
        yield from []

    def _static_signature(self):
        return (
            "EmpiricalDistribution",
            self.data.tobytes(),
            str(self.data.dtype),
            tuple(sorted((k, repr(v)) for k, v in self.kwargs.items())),
        )

    def _emit(self, ctx):
        q = ctx.column(self)
        method = self.kwargs.get("method", "linear")
        extra = {k: v for k, v in self.kwargs.items() if k != "method"}
        if method == "linear" and not extra and np.issubdtype(self.data.dtype, np.number):
            sorted_data = jnp.asarray(np.sort(self.data), config.float_dtype())
            grid = jnp.linspace(0.0, 1.0, self.data.shape[0], dtype=config.float_dtype())
            return jnp.interp(q, grid, sorted_data)

        # Exact numpy semantics for every other method.  The result dtype is
        # whatever np.quantile itself produces (interpolating methods return
        # floats even for integer data — casting back to the data dtype
        # would truncate e.g. midpoint quantiles of ints); probe it once at
        # trace time on a single quantile.
        import jax

        try:
            probe = np.quantile(a=self.data, q=np.float64(0.5), **self.kwargs)
            out_dtype = np.asarray(probe).dtype
        except TypeError:
            out_dtype = config.np_float_dtype()
        out_dtype = jax.dtypes.canonicalize_dtype(out_dtype)

        def host(q_np):
            return np.asarray(
                np.quantile(a=self.data, q=np.asarray(q_np, np.float64), **self.kwargs),
                out_dtype,
            )

        result = jax.ShapeDtypeStruct((ctx.n,), out_dtype)
        return jax.pure_callback(host, result, q)


class CumulativeDistribution(AbstractDistribution):
    """A distribution defined by piecewise-linear cumulative quantiles.

    Reference ``modeling.py:847-882``.

    >>> distr = CumulativeDistribution([0, 0.2, 0.8, 1], [10, 15, 20, 25])
    >>> np.asarray(distr.sample(3, random_state=42)).shape
    (3,)
    """

    is_leaf = True

    def __init__(self, quantiles, cumulatives):
        self.q = np.array(quantiles)
        self.cumulatives = np.array(cumulatives)
        # Same validation semantics as the reference node, own wording.
        if not np.all(np.diff(self.q) > 0):
            raise ValueError(
                "quantiles must form a strictly increasing sequence."
            )
        if not np.all(np.diff(self.cumulatives) > 0):
            raise ValueError(
                "cumulatives must form a strictly increasing sequence "
                "(a CDF table cannot have flat or decreasing segments)."
            )
        if not (np.isclose(np.min(self.q), 0) and np.isclose(np.max(self.q), 1)):
            raise ValueError(
                "Lowest quantile level must be 0 and the highest 1 (the "
                "table must span the whole CDF)."
            )
        super().__init__()

    def __repr__(self):
        return (
            f"{type(self).__name__}(quantiles={repr(self.q)}, "
            f"cumulatives={repr(self.cumulatives)})"
        )

    def get_parents(self):
        yield from []

    def _static_signature(self):
        return (
            "CumulativeDistribution",
            self.q.tobytes(),
            self.cumulatives.tobytes(),
        )

    def _emit(self, ctx):
        q = ctx.column(self)
        xp = jnp.asarray(self.q, config.float_dtype())
        fp = jnp.asarray(self.cumulatives, config.float_dtype())
        return jnp.interp(q, xp, fp)


class DiscreteDistribution(AbstractDistribution):
    """A discrete/categorical distribution over values with probabilities.

    Reference ``modeling.py:885-927``.  Sampling is a ``searchsorted`` into
    the cumulative probabilities on device.  Non-numeric values (e.g.
    strings) cannot live on the device: indices are sampled on device and gathered
    into the value array on host at the output boundary.
    """

    is_leaf = True

    def __init__(self, values, probabilities=None):
        self.values = np.array(values)
        if probabilities is None:
            self.probabilities = np.ones(len(self.values), dtype=float)
            self.probabilities = self.probabilities / np.sum(self.probabilities)
        else:
            self.probabilities = np.array(probabilities)

        if not len(self.values) == len(self.probabilities):
            raise ValueError(
                f"Length mismatch: {len(self.values)=}  {len(self.probabilities)=}"
            )
        if not np.isclose(np.sum(self.probabilities), 1.0):
            raise ValueError(f"Probabilities must sum to 1. {sum(self.probabilities)=}")
        if np.any(self.probabilities < 0):
            raise ValueError("Probabilities are not non-negative.")
        super().__init__()

    def __repr__(self):
        return (
            f"{type(self).__name__}(values={repr(self.values)}, "
            f"probabilities={repr(self.probabilities)})"
        )

    def get_parents(self):
        yield from []

    def _static_signature(self):
        return (
            "DiscreteDistribution",
            # tolist(), not repr(array): numpy truncates reprs past 1000
            # elements, which would collide signatures of different tables.
            self.values.tobytes()
            if self.values.dtype != object
            else repr(self.values.tolist()),
            str(self.values.dtype),
            self.probabilities.tobytes(),
        )

    def _emit(self, ctx):
        q = ctx.column(self)
        cumulative = jnp.asarray(
            np.cumsum(self.probabilities), config.float_dtype()
        )
        idx = jnp.searchsorted(cumulative, q, side="right")
        idx = jnp.minimum(idx, len(self.values) - 1)
        if np.issubdtype(self.values.dtype, np.number):
            return jnp.take(jnp.asarray(self.values), idx)
        # Non-numeric values: indices on device, host gather at the boundary.
        return idx

    def _host_finalizer(self):
        """Gather non-numeric values on host (strings cannot live on the device)."""
        if np.issubdtype(self.values.dtype, np.number):
            return None
        values = self.values
        return lambda idx: values[np.asarray(idx)]


class CopulaDistribution(AbstractDistribution):
    """(n, d) draws with uniform marginals and an Archimedean copula's
    dependence (framework extension; the reference's only dependence
    tools are correlation matrices, ``correlation.py:161-425``).

    Unpack through :class:`MarginalDistribution` slices — use the
    ``ClaytonCopula`` / ``GumbelCopula`` / ``FrankCopula`` factories
    (``models/factories.py``), then shape each uniform marginal with
    ``QuantileTransform``.

    Randomness follows the multivariate q[0]-seed contract
    (``modeling.py:808-812``): the node consumes one quantile column and
    keys its device sampler from the leading quantile bits, so draws are
    reproducible per random_state and stream/shard like any other node.

    >>> CopulaDistribution("clayton", theta=2.0, d=3)
    CopulaDistribution("clayton", theta=2, d=3)
    """

    is_leaf = True
    # (n, d)-valued: cannot join a correlate() declaration directly
    # (engine/compile._analyze_correlations guards on this).
    _vector_valued = True
    # Randomness comes from a column-seeded PRNG key, not the column
    # itself: streamed method= runs reject such graphs (bitwise contract).
    _key_seeded = True

    def __init__(self, family, theta, d):
        from probabilit_tpu.ops import copulas

        theta, d = copulas.validate(family, theta, d)
        self.family = str(family)
        self.theta = theta
        self.d = d
        super().__init__()

    def __repr__(self):
        return (
            f'{type(self).__name__}("{self.family}", '
            f"theta={self.theta:g}, d={self.d})"
        )

    def get_parents(self):
        return iter(())

    def _rewire(self, update):
        pass

    def _static_signature(self):
        return ("CopulaDistribution", self.family, self.theta, self.d)

    def _mv_dim(self):
        return self.d

    def _emit(self, ctx):
        import jax as _jax

        from probabilit_tpu.ops import copulas
        from probabilit_tpu.ops import multivariate as mv
        from probabilit_tpu.parallel import mesh as _mesh

        q = ctx.column(self)
        key = mv._key_from_q(q)
        u = copulas.sample(
            self.family, key, (ctx.n, self.d), self.theta, config.float_dtype()
        )
        # Pin the sample axis under a mesh: key-based draws carry no
        # sharding of their own and would otherwise replicate (n, d)
        # per device (same rationale as PathDistribution._emit).
        sharding = _mesh.sample_sharding(ndim=2)
        if sharding is not None:
            u = _jax.lax.with_sharding_constraint(u, sharding)
        return u


class MarginalDistribution(Transform):
    """A 'slice' of a multivariate distribution (``modeling.py:1215-1243``).

    >>> distr = Distribution("multinomial", n=10, p=[0.1, 0.2, 0.7])
    >>> MarginalDistribution(distr, d=0)
    MarginalDistribution(Distribution("multinomial", n=10, p=[0.1, 0.2, 0.7]), d=0)
    """

    is_leaf = False

    def __init__(self, distr, d):
        self.distr = distr
        self.d = d
        super().__init__()

    def get_parents(self):
        yield self.distr

    def _rewire(self, update):
        self.distr = update(self.distr)

    def __repr__(self):
        return f"{type(self).__name__}({self.distr}, d={self.d})"

    def _static_signature(self):
        return ("MarginalDistribution", self.d)

    def _emit(self, ctx):
        value = ctx.value(self.distr)
        return jnp.atleast_2d(value)[:, self.d]


class EllipticalCopulaDistribution(AbstractDistribution):
    """(n, d) uniform-marginal draws with Gaussian or Student-t
    dependence (shape matrix + optional df), the elliptical siblings of
    :class:`CopulaDistribution`.  Use the ``GaussianCopula`` /
    ``TCopula`` factories and unpack the marginal views.

    Same q[0]-seeding, streaming, and sharding contracts as
    ``CopulaDistribution``.
    """

    is_leaf = True
    _vector_valued = True
    _key_seeded = True

    def __init__(self, family, corr, df=None):
        from probabilit_tpu.ops import copulas

        chol, d, df = copulas.validate_elliptical(family, corr, df)
        self.family = str(family)
        self.corr = np.asarray(corr, np.float64)
        self._chol = chol
        self.df = df
        self.d = d
        super().__init__()

    def __repr__(self):
        extra = "" if self.df is None else f", df={self.df:g}"
        return (
            f'{type(self).__name__}("{self.family}", d={self.d}{extra})'
        )

    def get_parents(self):
        return iter(())

    def _rewire(self, update):
        pass

    def _static_signature(self):
        return (
            "EllipticalCopulaDistribution",
            self.family,
            self.corr.tobytes(),
            self.df,
        )

    def _mv_dim(self):
        return self.d

    def _emit(self, ctx):
        import jax as _jax

        from probabilit_tpu.ops import copulas
        from probabilit_tpu.ops import multivariate as mv
        from probabilit_tpu.parallel import mesh as _mesh

        q = ctx.column(self)
        key = mv._key_from_q(q)
        u = copulas.elliptical_sample(
            self.family, key, ctx.n, self._chol, self.df, config.float_dtype()
        )
        sharding = _mesh.sample_sharding(ndim=2)
        if sharding is not None:
            u = _jax.lax.with_sharding_constraint(u, sharding)
        return u


class EmpiricalCopulaDistribution(AbstractDistribution):
    """(n, d) draws with the EMPIRICAL dependence of observed data.

    Nonparametric member of the copula family: rows of the data's rank
    pseudo-observations (``rank/(m+1)``) are bootstrapped, so the joint
    rank structure is exactly the sample's — no parametric family
    assumed.  Use the ``EmpiricalCopula`` factory and shape marginal
    views with ``QuantileTransform``.  Same q[0]-seeding, streaming,
    and sharding contracts as the parametric copula nodes.
    """

    is_leaf = True
    _vector_valued = True
    _key_seeded = True

    def __init__(self, data):
        from probabilit_tpu.ops import copulas

        self.pseudo = copulas.empirical_pseudo_observations(data)
        self.d = self.pseudo.shape[1]
        super().__init__()

    def __repr__(self):
        return (
            f"{type(self).__name__}(m={self.pseudo.shape[0]}, d={self.d})"
        )

    def get_parents(self):
        return iter(())

    def _rewire(self, update):
        pass

    def _static_signature(self):
        return ("EmpiricalCopulaDistribution", self.pseudo.tobytes())

    def _mv_dim(self):
        return self.d

    def _emit(self, ctx):
        import jax as _jax

        from probabilit_tpu.ops import copulas
        from probabilit_tpu.ops import multivariate as mv
        from probabilit_tpu.parallel import mesh as _mesh

        q = ctx.column(self)
        key = mv._key_from_q(q)
        u = copulas.empirical_sample(
            key, ctx.n, self.pseudo, config.float_dtype()
        )
        sharding = _mesh.sample_sharding(ndim=2)
        if sharding is not None:
            u = _jax.lax.with_sharding_constraint(u, sharding)
        return u


class QuantileTransform(Transform):
    """Push a (0,1)-valued node through a named family's inverse CDF.

    Framework extension (no reference counterpart): turns any node whose
    values live in the open unit interval — a copula marginal, a
    user-computed probability, a rank statistic — into draws from a
    named scipy.stats family via the native device ppf kernels
    (``ops/ppf.py``).  This is the piece that makes Archimedean copula
    modeling compositional:

    >>> u1, u2 = ClaytonCopula(theta=2.0)  # doctest: +SKIP
    >>> x = QuantileTransform(u1, "lognorm", s=0.5)  # doctest: +SKIP

    Parameters may be numbers or other nodes, like ``Distribution``.
    Values are clamped to the open unit interval before inversion — at
    the WIDE floor (~1e-37 f32, ``ops/qmc.clamp_open_unit_wide``), not
    the 2^-24 RNG grid, so deliberately-tiny derived quantiles
    (importance tilts, survival windows) keep their depth; families
    with a wide kernel (norm, lognorm — ``ops.ppf.call_wide``) resolve
    them exactly.  Values OUTSIDE [0, 1] are a modeling error and
    produce the same non-finite-sample failure any invalid transform
    does.

    >>> from probabilit_tpu.modeling import Distribution
    >>> QuantileTransform(Distribution("uniform"), "norm", loc=1)
    QuantileTransform(Distribution("uniform"), "norm", loc=1)
    """

    def __init__(self, node, distr, *args, **kwargs):
        if not isinstance(node, Node):
            raise TypeError(
                f"QuantileTransform needs a graph node, got {node!r}."
            )
        self.node = node
        self.distr = str(distr)
        self.args = args
        self.kwargs = kwargs
        super().__init__()

    def __repr__(self):
        from probabilit_tpu.models.graph import Transform as _T

        if _T._repr_capped():
            return f'{type(self).__name__}(..., "{self.distr}")'
        with _T._repr_frame():
            parts = [repr(self.node), f'"{self.distr}"']
            parts += [repr(a) for a in self.args]
            parts += [f"{k}={v!r}" for k, v in self.kwargs.items()]
        return f"{type(self).__name__}({', '.join(parts)})"

    def get_parents(self):
        yield self.node
        for arg in self.args + tuple(self.kwargs.values()):
            if isinstance(arg, Node):
                yield arg

    def _rewire(self, update):
        self.node = update(self.node)
        self.args = tuple(update(a) for a in self.args)
        self.kwargs = {k: update(v) for k, v in self.kwargs.items()}

    def _static_signature(self):
        sig_args = tuple(
            "<node>" if isinstance(a, Node) else repr(a) for a in self.args
        )
        sig_kwargs = tuple(
            (k, "<node>" if isinstance(v, Node) else repr(v))
            for k, v in sorted(self.kwargs.items())
        )
        return ("QuantileTransform", self.distr, sig_args, sig_kwargs)

    def _emit(self, ctx):
        from probabilit_tpu.ops.qmc import clamp_open_unit_wide

        def unpack(arg):
            return ctx.value(arg) if isinstance(arg, Node) else arg

        # Wide clamp + wide kernels: a DERIVED quantile (importance
        # tilt, survival-space window) is legitimately far below the
        # 2^-24 RNG grid; families with a wide variant resolve it down
        # to ~1e-37 (f32).
        u = clamp_open_unit_wide(
            jnp.asarray(ctx.value(self.node), config.float_dtype())
        )
        args = tuple(unpack(a) for a in self.args)
        kwargs = {k: unpack(v) for k, v in self.kwargs.items()}
        return ppf.call_wide(self.distr, u, *args, **kwargs)


def MultivariateDistribution(distr, *args, **kwargs):
    """Factory yielding the marginal slices of a multivariate distribution.

    Mirrors reference ``modeling.py:1246-1264``: constraints are (1) leaf
    node only, (2) unpack all marginals, (3) pseudo-random sampling only.

    >>> d1, d2 = MultivariateDistribution("dirichlet", alpha=[1, 2])
    >>> d1
    MarginalDistribution(Distribution("dirichlet", alpha=[1, 2]), d=0)
    """
    node = Distribution(distr, *args, **kwargs)
    d = node._mv_dim()
    yield from (MarginalDistribution(node, d=i) for i in range(d))
