"""Lightweight labeled-array containers (accelerator-native substrate).

The reference library (jordandeklerk/pyloo) builds its data layer on
``xarray.DataArray`` / ``arviz.InferenceData`` (see reference
``pyloo/utils.py:21-79``).  This rebuild provides an equivalent, dependency-free
substrate: a minimal named-dimension array (:class:`DataArray`), a mapping of
them (:class:`Dataset`), and a grouped container (:class:`InferenceData`).

Design notes
------------
Host metadata (dims, coords) lives here; the numeric payload is a plain
``numpy`` array.  Device computation happens in :mod:`pyloo_tpu.ops`, which
consumes/returns raw arrays — the labeled layer never crosses into jitted code.
Only the small slice of xarray semantics actually exercised by the LOO-CV
workflows is implemented (stacking ``(chain, draw) -> __sample__``, integer/
array selection, dimension-wise reductions, dims-aligned arithmetic).
"""

from __future__ import annotations

from typing import Any, Mapping

import numpy as np

__all__ = ["DataArray", "Dataset", "InferenceData"]

# ``stack`` defers its transpose-copy for payloads at least this large so the
# obs-major swap can run on device (HBM bandwidth) instead of on the host
# (single-threaded strided copy).  Tests lower this to 0 to exercise the lazy
# representation end-to-end at small shapes.
_LAZY_STACK_MIN_ELEMS = 1 << 20


def _as_array(values: Any) -> np.ndarray:
    """Coerce to a host numpy array (materializes JAX arrays)."""
    return np.asarray(values)


class DataArray:
    """N-dimensional array with named dimensions and per-dimension coordinates.

    Parameters
    ----------
    values : array-like
        The data payload.
    dims : sequence of str
        One name per axis of ``values``.
    coords : mapping, optional
        Maps a dim name to a 1-D label array of matching length.  Dims without
        entries are positionally indexed.
    name : str, optional
    """

    __slots__ = ("_values", "_lazy", "dims", "coords", "name")

    def __init__(self, values, dims=None, coords=None, name=None):
        self._lazy = None
        self._values = _as_array(values)
        if dims is None:
            dims = tuple(f"dim_{i}" for i in range(self._values.ndim))
        dims = tuple(dims)
        if len(dims) != self._values.ndim:
            raise ValueError(
                f"dims {dims} incompatible with array of ndim {self._values.ndim}"
            )
        self.dims = dims
        self.coords = {}
        if coords:
            for key, val in coords.items():
                if key not in dims:
                    continue
                arr = np.asarray(val)
                self.coords[key] = arr
        self.name = name

    @classmethod
    def _lazy_stacked(cls, base, order, n_collapse, dims, coords, name):
        """A stacked array whose transpose-copy has not happened yet.

        ``base`` is the pre-stack payload; materializing applies
        ``base.transpose(order)`` and collapses the trailing ``n_collapse``
        axes.  Until then, device consumers (``base.as_sample_matrix``) can
        ship ``base`` as-is and do the axis swap on device.
        """
        obj = cls.__new__(cls)
        obj._values = None
        obj._lazy = (base, tuple(order), int(n_collapse))
        obj.dims = tuple(dims)
        obj.coords = dict(coords)
        obj.name = name
        return obj

    @property
    def values(self):
        if self._values is None:
            base, order, k = self._lazy
            v = base.transpose(order)
            self._values = v.reshape(v.shape[: v.ndim - k] + (-1,))
            self._lazy = None
        return self._values

    @values.setter
    def values(self, new):
        self._values = _as_array(new)
        self._lazy = None

    def _elementwise_values(self):
        """The payload in SOME layout, for order-independent scans (isnan etc.).

        Returns the un-transposed base of a lazy-stacked array — same elements,
        different order — without triggering the materializing copy.
        """
        if self._values is None:
            return self._lazy[0]
        return self._values

    # -- basic introspection ------------------------------------------------
    @property
    def shape(self):
        if self._values is None:
            base, order, k = self._lazy
            pre = tuple(base.shape[i] for i in order)
            lead = pre[: len(pre) - k]
            collapsed = 1
            for s in pre[len(pre) - k :]:
                collapsed *= s
            return lead + (collapsed,)
        return self._values.shape

    @property
    def ndim(self):
        return len(self.dims)

    @property
    def size(self):
        if self._values is None:
            return self._lazy[0].size
        return self._values.size

    @property
    def dtype(self):
        if self._values is None:
            return self._lazy[0].dtype
        return self._values.dtype

    @property
    def sizes(self):
        return dict(zip(self.dims, self.shape))

    def __len__(self):
        return self.values.shape[0]

    def __repr__(self):
        header = f"<DataArray {self.name or ''} {tuple(zip(self.dims, self.shape))}>"
        return f"{header}\n{self.values!r}"

    def __array__(self, dtype=None, copy=None):
        arr = self.values
        if dtype is not None:
            arr = arr.astype(dtype)
        return arr

    def __iter__(self):
        for i in range(self.shape[0]):
            yield self.isel({self.dims[0]: i})

    def item(self):
        return self.values.item()

    def copy(self, deep=True):
        vals = self.values.copy() if deep else self.values
        return DataArray(vals, self.dims, dict(self.coords), self.name)

    # -- dim/coord access ---------------------------------------------------
    def get_index(self, dim):
        if dim in self.coords:
            return self.coords[dim]
        return np.arange(self.sizes[dim])

    def __getitem__(self, key):
        if isinstance(key, str):
            # coordinate lookup, mirroring xarray's ``da[dim]``
            return DataArray(self.get_index(key), (key,), name=key)
        if not isinstance(key, tuple):
            key = (key,)
        indexers = {}
        for dim, sub in zip(self.dims, key):
            indexers[dim] = sub
        return self.isel(indexers)

    def rename(self, name):
        return DataArray(self.values, self.dims, dict(self.coords), name)

    def astype(self, dtype):
        return DataArray(self.values.astype(dtype), self.dims, dict(self.coords), self.name)

    # -- selection ----------------------------------------------------------
    def isel(self, indexers: Mapping[str, Any] | None = None, **kwargs):
        """Integer/slice/array selection by dimension name."""
        indexers = dict(indexers or {})
        indexers.update(kwargs)
        values = self.values
        new_dims = []
        new_coords = {}
        # apply one dim at a time so fancy indexing never cross-couples axes
        axis_of = {d: i for i, d in enumerate(self.dims)}
        drop = set()
        for dim, sub in indexers.items():
            if dim not in axis_of:
                raise KeyError(f"no dimension named {dim!r}; have {self.dims}")
            axis = axis_of[dim]
            idx = [slice(None)] * values.ndim
            if isinstance(sub, (int, np.integer)):
                idx[axis] = int(sub)
                values = values[tuple(idx)]
                drop.add(dim)
                # realign axis numbers after the collapse
                axis_of = {
                    d: (i if i < axis else i - 1)
                    for d, i in axis_of.items()
                    if d != dim
                }
            else:
                sub = np.asarray(sub) if not isinstance(sub, slice) else sub
                idx[axis] = sub
                values = values[tuple(idx)]
        for dim in self.dims:
            if dim in drop:
                continue
            new_dims.append(dim)
            if dim in self.coords:
                sub = indexers.get(dim)
                if sub is None:
                    new_coords[dim] = self.coords[dim]
                elif isinstance(sub, slice):
                    new_coords[dim] = self.coords[dim][sub]
                else:
                    new_coords[dim] = self.coords[dim][np.asarray(sub)]
        return DataArray(values, tuple(new_dims), new_coords, self.name)

    def sel(self, indexers: Mapping[str, Any] | None = None, **kwargs):
        """Label-based selection (exact matches against coords)."""
        indexers = dict(indexers or {})
        indexers.update(kwargs)
        positional = {}
        for dim, label in indexers.items():
            index = self.get_index(dim)
            labels = np.asarray(label)
            if labels.ndim == 0:
                matches = np.nonzero(index == labels[()])[0]
                if matches.size == 0:
                    raise KeyError(f"label {label!r} not found in dim {dim!r}")
                positional[dim] = int(matches[0])
            else:
                lookup = {v: i for i, v in enumerate(index)}
                positional[dim] = np.asarray([lookup[v] for v in labels])
        return self.isel(positional)

    # -- reshaping ----------------------------------------------------------
    def transpose(self, *dims):
        if not dims:
            dims = tuple(reversed(self.dims))
        order = [self.dims.index(d) for d in dims]
        return DataArray(
            self.values.transpose(order), tuple(dims), dict(self.coords), self.name
        )

    def stack(self, **mapping):
        """Collapse dims into one new trailing dim (xarray ordering semantics).

        When the collapse would force a transpose-copy of a large payload
        (e.g. the canonical ``(chain, draw, obs)`` log-likelihood layout), the
        copy is DEFERRED: the result carries the original array plus the axis
        permutation, and materializes only if host code reads ``.values``.
        Device consumers (:func:`pyloo_tpu.base.as_sample_matrix`) detect the
        deferred form and perform the swap on device instead.
        """
        out = self
        for new_dim, old_dims in mapping.items():
            old_dims = tuple(old_dims)
            keep = tuple(d for d in out.dims if d not in old_dims)
            order = tuple(out.dims.index(d) for d in keep + old_dims)
            coords = {d: c for d, c in out.coords.items() if d in keep}
            # stacked coordinate: tuples of the component labels
            comp = [out.get_index(d) for d in old_dims]
            mesh = np.meshgrid(*comp, indexing="ij")
            stacked = np.empty(mesh[0].size, dtype=object)
            flat = [m.ravel() for m in mesh]
            for i in range(mesh[0].size):
                stacked[i] = tuple(f[i] for f in flat)
            coords[new_dim] = stacked
            new_dims = keep + (new_dim,)
            base = out.values
            view = base.transpose(order)
            lead = view.shape[: len(keep)]
            if view.size >= _LAZY_STACK_MIN_ELEMS and not view.flags.c_contiguous:
                out = DataArray._lazy_stacked(
                    base, order, len(old_dims), new_dims, coords, out.name
                )
            else:
                out = DataArray(view.reshape(lead + (-1,)), new_dims, coords, out.name)
        return out

    def expand_dims(self, dim, axis=0):
        values = np.expand_dims(self.values, axis)
        dims = list(self.dims)
        dims.insert(axis, dim)
        return DataArray(values, tuple(dims), dict(self.coords), self.name)

    # -- reductions ---------------------------------------------------------
    def _reduce(self, fn, dim=None, **kwargs):
        if dim is None:
            return fn(self.values, **kwargs)
        if isinstance(dim, str):
            dim = (dim,)
        axes = tuple(self.dims.index(d) for d in dim)
        values = fn(self.values, axis=axes, **kwargs)
        new_dims = tuple(d for d in self.dims if d not in dim)
        coords = {d: c for d, c in self.coords.items() if d in new_dims}
        return DataArray(values, new_dims, coords, self.name)

    def mean(self, dim=None, **kw):
        return self._reduce(np.mean, dim, **kw)

    def sum(self, dim=None, **kw):
        return self._reduce(np.sum, dim, **kw)

    def std(self, dim=None, **kw):
        return self._reduce(np.std, dim, **kw)

    def var(self, dim=None, **kw):
        return self._reduce(np.var, dim, **kw)

    def min(self, dim=None, **kw):
        return self._reduce(np.min, dim, **kw)

    def max(self, dim=None, **kw):
        return self._reduce(np.max, dim, **kw)

    # -- arithmetic ---------------------------------------------------------
    def _coerce_other(self, other):
        """Align ``other`` to this array's dim order; return a broadcastable ndarray."""
        if isinstance(other, DataArray):
            if set(other.dims) == set(self.dims):
                return other.transpose(*self.dims).values
            if set(other.dims) <= set(self.dims):
                # broadcast a reduced array back across the missing leading dims
                missing = [d for d in self.dims if d not in other.dims]
                aligned = other
                for d in missing:
                    aligned = aligned.expand_dims(d, axis=0)
                return aligned.transpose(*self.dims).values
            raise ValueError(f"cannot align dims {other.dims} with {self.dims}")
        return other

    def _binop(self, other, op, reflexive=False):
        arr = self._coerce_other(other)
        values = op(arr, self.values) if reflexive else op(self.values, arr)
        return DataArray(values, self.dims, dict(self.coords), self.name)

    def __add__(self, o):
        return self._binop(o, np.add)

    def __radd__(self, o):
        return self._binop(o, np.add, True)

    def __sub__(self, o):
        return self._binop(o, np.subtract)

    def __rsub__(self, o):
        return self._binop(o, np.subtract, True)

    def __mul__(self, o):
        return self._binop(o, np.multiply)

    def __rmul__(self, o):
        return self._binop(o, np.multiply, True)

    def __truediv__(self, o):
        return self._binop(o, np.divide)

    def __rtruediv__(self, o):
        return self._binop(o, np.divide, True)

    def __pow__(self, o):
        return self._binop(o, np.power)

    def __neg__(self):
        return DataArray(-self.values, self.dims, dict(self.coords), self.name)

    def __gt__(self, o):
        return self._binop(o, np.greater)

    def __lt__(self, o):
        return self._binop(o, np.less)

    def __ge__(self, o):
        return self._binop(o, np.greater_equal)

    def __le__(self, o):
        return self._binop(o, np.less_equal)

    def where(self, cond, other=np.nan):
        cond_arr = self._coerce_other(cond) if isinstance(cond, DataArray) else cond
        other_arr = self._coerce_other(other) if isinstance(other, DataArray) else other
        return DataArray(
            np.where(cond_arr, self.values, other_arr),
            self.dims,
            dict(self.coords),
            self.name,
        )


class Dataset:
    """An ordered mapping of named :class:`DataArray` variables."""

    def __init__(self, variables: Mapping[str, DataArray] | None = None, attrs=None):
        self._variables: dict[str, DataArray] = {}
        if variables:
            for k, v in variables.items():
                if not isinstance(v, DataArray):
                    v = DataArray(v, name=k)
                self._variables[k] = v.rename(k)
        self.attrs = dict(attrs or {})

    @property
    def data_vars(self):
        return dict(self._variables)

    @property
    def dims(self):
        out: dict[str, int] = {}
        for v in self._variables.values():
            out.update(v.sizes)
        return out

    def __contains__(self, key):
        return key in self._variables

    def __getitem__(self, key):
        if isinstance(key, list):
            return Dataset({k: self._variables[k] for k in key}, self.attrs)
        return self._variables[key]

    def __setitem__(self, key, value):
        if not isinstance(value, DataArray):
            value = DataArray(value, name=key)
        self._variables[key] = value.rename(key)

    def __getattr__(self, key):
        variables = object.__getattribute__(self, "_variables")
        if key in variables:
            return variables[key]
        raise AttributeError(key)

    def __iter__(self):
        return iter(self._variables)

    def __len__(self):
        return len(self._variables)

    def items(self):
        return self._variables.items()

    def keys(self):
        return self._variables.keys()

    def values(self):
        return self._variables.values()

    def isel(self, indexers=None, **kwargs):
        indexers = dict(indexers or {})
        indexers.update(kwargs)
        out = {}
        for k, v in self._variables.items():
            sub = {d: i for d, i in indexers.items() if d in v.dims}
            out[k] = v.isel(sub) if sub else v
        return Dataset(out, self.attrs)

    def stack(self, **mapping):
        out = {}
        for k, v in self._variables.items():
            applicable = {
                new: dims for new, dims in mapping.items() if set(dims) <= set(v.dims)
            }
            out[k] = v.stack(**applicable) if applicable else v
        return Dataset(out, self.attrs)

    def mean(self, dim=None):
        return Dataset({k: v.mean(dim) for k, v in self._variables.items()}, self.attrs)

    def copy(self, deep=True):
        return Dataset(
            {k: v.copy(deep) for k, v in self._variables.items()}, dict(self.attrs)
        )

    def __repr__(self):
        lines = [f"<Dataset ({len(self._variables)} variables)>"]
        for k, v in self._variables.items():
            lines.append(f"  {k}: {tuple(zip(v.dims, v.shape))}")
        return "\n".join(lines)


_KNOWN_GROUPS = (
    "posterior",
    "posterior_predictive",
    "log_likelihood",
    "sample_stats",
    "prior",
    "prior_predictive",
    "observed_data",
    "constant_data",
    "predictions",
)


class InferenceData:
    """Grouped container of MCMC results (posterior, log_likelihood, ...).

    Capability-equivalent to ``arviz.InferenceData`` for every access pattern
    used by the LOO-CV estimators: attribute access per group, ``hasattr``
    checks, and group iteration.
    """

    def __init__(self, **groups):
        self._groups: list[str] = []
        for name, dataset in groups.items():
            if dataset is None:
                continue
            self.add_group(name, dataset)

    def add_group(self, name, dataset):
        if not isinstance(dataset, Dataset):
            dataset = Dataset(dataset)
        object.__setattr__(self, name, dataset)
        if name not in self._groups:
            self._groups.append(name)

    def groups(self):
        return list(self._groups)

    def __contains__(self, name):
        return name in self._groups

    def copy(self):
        return InferenceData(**{g: getattr(self, g).copy() for g in self._groups})

    def to_netcdf(self, path):
        """Write to a netCDF4/HDF5 file readable by arviz/xarray and
        :func:`pyloo_tpu.from_netcdf` (see :mod:`pyloo_tpu.ingest`)."""
        from .ingest import save_netcdf

        return save_netcdf(self, path)

    def __repr__(self):
        lines = ["InferenceData with groups:"]
        lines += [f"\t> {g}" for g in self._groups]
        return "\n".join(lines)
