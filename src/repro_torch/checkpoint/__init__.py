"""Tree checkpointing in the JAX package's format: npz leaves + msgpack
metadata.  The port of ``repro.checkpoint``.

  <dir>/step_<N>/arrays.npz     flattened leaves keyed by path string
  <dir>/step_<N>/meta.msgpack   {step, metadata, paths, dtypes}

A checkpoint saved by either package restores in the other:

* leaf keys are the reference's ``jax.tree_util`` key paths joined by
  ``/``: a dict key as ``str(key)``, a list or tuple index as
  ``str(index)``, a NamedTuple field as ``.name``, and ``None`` leaves
  dropped (``state/.params/layers/0/attn/wq``, ``state/.step``);
* dtypes numpy has no type for (bfloat16, float8) are stored as unsigned
  integer views of the same width, their true dtype named in
  ``meta["dtypes"]``;
* ``meta.msgpack`` is written and read by the port's own codec
  (:mod:`._msgpack`).

``save`` writes atomically (tmp dir + rename), one leaf at a time, so the
host holds one leaf of a large tree at once.  ``restore`` reads into the
structure of a template and returns CPU tensors, which the caller moves to
its device.
"""

from __future__ import annotations

import concurrent.futures
import os
import re
import shutil
import tempfile
import zipfile

import numpy as np
import torch

from . import _msgpack

__all__ = ["save", "restore", "latest_step", "flatten_with_paths",
           "leaf_shape"]

# torch dtypes without a numpy dtype, by the name the reference records
# (the ml_dtypes names), stored as the unsigned view of the same width
_VIEW_DTYPES = {torch.bfloat16: "bfloat16",
                torch.float8_e4m3fn: "float8_e4m3fn",
                torch.float8_e5m2: "float8_e5m2"}
_BY_NAME = {name: dt for dt, name in _VIEW_DTYPES.items()}
_SIGNED_VIEW = {1: torch.int8, 2: torch.int16}


def _is_namedtuple(x) -> bool:
    return isinstance(x, tuple) and hasattr(x, "_fields")


def flatten_with_paths(tree, prefix: str = "") -> list:
    """``[(key, leaf), ...]`` of a tree of dicts, lists, tuples and
    NamedTuples, with the JAX package's key strings; ``None`` leaves are
    dropped, as JAX drops them.  Order: the tree's own (dicts in insertion
    order); the format keys leaves by name, so order does not matter."""
    out = []
    _walk(tree, [prefix] if prefix else [], out)
    return out


def _walk(node, path: list, out: list) -> None:
    # a module-level function, not a closure over itself: a recursive
    # closure is a reference cycle that would keep the leaves (a train
    # state's device tensors) alive until the garbage collector runs
    if node is None:
        return
    if isinstance(node, dict):
        items = [(str(k), v) for k, v in node.items()]
    elif _is_namedtuple(node):
        items = [("." + f, getattr(node, f)) for f in node._fields]
    elif isinstance(node, (list, tuple)):
        items = [(str(i), v) for i, v in enumerate(node)]
    else:
        out.append(("/".join(path), node))
        return
    for k, v in items:
        _walk(v, path + [k], out)


def _map_with_paths(fn, tree, path=()):
    """``tree`` with each leaf replaced by ``fn(key, leaf)`` (None kept)."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return type(tree)((k, _map_with_paths(fn, v, path + (str(k),)))
                          for k, v in tree.items())
    if _is_namedtuple(tree):
        return type(tree)(*(_map_with_paths(fn, getattr(tree, f),
                                            path + ("." + f,))
                            for f in tree._fields))
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map_with_paths(fn, v, path + (str(i),))
                          for i, v in enumerate(tree))
    return fn("/".join(path), tree)


def _encode(leaf) -> tuple[np.ndarray, str | None]:
    """A leaf (or a future of one) as the numpy array the npz stores, and
    its true dtype's name where the array is a view."""
    if isinstance(leaf, concurrent.futures.Future):
        leaf = leaf.result()
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu()
        if t.dtype in _VIEW_DTYPES:
            view = t.view(_SIGNED_VIEW[t.element_size()]).numpy()
            return (view.view(np.dtype(f"u{t.element_size()}")),
                    _VIEW_DTYPES[t.dtype])
        return t.numpy(), None
    return np.asarray(leaf), None


def _decode(arr: np.ndarray, true_dtype: str | None) -> torch.Tensor:
    if not arr.flags.c_contiguous:
        arr = arr.copy(order="C")
    if true_dtype is None:
        return torch.from_numpy(arr)
    dtype = _BY_NAME.get(true_dtype)
    if dtype is None:
        raise TypeError(f"checkpoint leaf dtype {true_dtype!r} has no "
                        f"torch counterpart")
    return torch.from_numpy(arr.view(f"i{arr.dtype.itemsize}")).view(dtype)


def _write_npz(path: str, leaves: list) -> dict:
    """``np.savez``'s layout (stored, zip64 members named ``<key>.npy``),
    encoding one leaf at a time.  Returns {key: true dtype} of the view
    leaves."""
    dtypes = {}
    with zipfile.ZipFile(path, mode="w", compression=zipfile.ZIP_STORED,
                         allowZip64=True) as zf:
        for key, leaf in leaves:
            arr, true_dtype = _encode(leaf)
            if true_dtype:
                dtypes[key] = true_dtype
            with zf.open(key + ".npy", "w", force_zip64=True) as fh:
                np.lib.format.write_array(fh, np.asanyarray(arr),
                                          allow_pickle=False)
    return dtypes


def _read_header(fh) -> tuple:
    """(shape, fortran_order, dtype) of the ``.npy`` member open in
    ``fh``, which is left at the start of its data."""
    version = np.lib.format.read_magic(fh)
    read_header = (np.lib.format.read_array_header_1_0 if version == (1, 0)
                   else np.lib.format.read_array_header_2_0)
    return read_header(fh)


def leaf_shape(npz_path: str, key: str) -> tuple | None:
    """The shape of one stored leaf, read from its header alone (None when
    the checkpoint has no such leaf)."""
    with zipfile.ZipFile(npz_path) as zf:
        if key + ".npy" not in zf.namelist():
            return None
        with zf.open(key + ".npy") as fh:
            shape, _, _ = _read_header(fh)
    return tuple(shape)


def _read_rows(zf, key: str, rows: slice) -> tuple[np.ndarray, tuple]:
    """Rows ``rows`` of the leading dim of a stored leaf, read alone (the
    members are stored uncompressed, so the reader seeks past the rows
    before them; a scalar is read whole), and the leaf's whole shape."""
    with zf.open(key + ".npy") as fh:
        shape, fortran, dtype = _read_header(fh)
        if not shape:
            return np.frombuffer(fh.read(dtype.itemsize), dtype).reshape(
                ()).copy(), ()
        if fortran:
            raise ValueError(f"{key}: a Fortran-ordered leaf's rows are not "
                             f"contiguous")
        start, stop, _ = rows.indices(shape[0])
        row_bytes = int(np.prod(shape[1:], dtype=np.int64)) * dtype.itemsize
        fh.seek(fh.tell() + start * row_bytes)
        data = fh.read((stop - start) * row_bytes)
    arr = np.frombuffer(data, dtype=dtype).reshape(
        (stop - start,) + tuple(shape[1:]))
    return arr.copy(), tuple(shape)


def _sweep_orphan_tmpdirs(directory: str) -> None:
    """Remove ``.tmp_ckpt_*`` leftovers from interrupted saves.  An
    interrupted ``save`` dies between mkdtemp and the atomic rename, so any
    tmp dir present when a NEW save starts is garbage by construction
    (single-writer format)."""
    for name in os.listdir(directory):
        if name.startswith(".tmp_ckpt_"):
            shutil.rmtree(os.path.join(directory, name), ignore_errors=True)


# only exact step_<digits> names are checkpoints; stray entries (a user's
# step_notes dir, editor droppings) are ignored rather than crashing saves
_STEP_RE = re.compile(r"^step_(\d+)$")


def _step_entries(directory: str) -> list[tuple[int, str]]:
    out = []
    for name in os.listdir(directory):
        m = _STEP_RE.match(name)
        if m:
            out.append((int(m.group(1)), name))
    return sorted(out)


def _prune_old(directory: str, keep_last: int) -> None:
    entries = _step_entries(directory)
    for _, name in entries[:-keep_last] if keep_last else entries:
        shutil.rmtree(os.path.join(directory, name), ignore_errors=True)


def save(directory: str, step: int, tree, metadata: dict | None = None,
         keep_last: int | None = None) -> str:
    """Atomic checkpoint write of a tree of tensors (any device) or numpy
    arrays, or ``concurrent.futures.Future``s of them, each awaited when
    its turn to be written comes (so that another thread may produce the
    leaves while this one writes).  ``keep_last=N`` prunes all but the N newest ``step_*`` dirs
    after a successful write (None keeps everything); orphaned
    ``.tmp_ckpt_*`` dirs from previously interrupted saves are swept on
    entry either way."""
    if keep_last is not None and keep_last < 1:
        raise ValueError(f"keep_last must be >= 1, got {keep_last}")
    os.makedirs(directory, exist_ok=True)
    _sweep_orphan_tmpdirs(directory)
    final = os.path.join(directory, f"step_{step:08d}")
    tmp = tempfile.mkdtemp(dir=directory, prefix=".tmp_ckpt_")
    try:
        leaves = flatten_with_paths(tree)
        dtypes = _write_npz(os.path.join(tmp, "arrays.npz"), leaves)
        meta = {"step": step, "metadata": metadata or {},
                "paths": sorted(key for key, _ in leaves), "dtypes": dtypes}
        with open(os.path.join(tmp, "meta.msgpack"), "wb") as f:
            f.write(_msgpack.packb(meta))
        if os.path.exists(final):
            shutil.rmtree(final)
        os.rename(tmp, final)
    except BaseException:
        shutil.rmtree(tmp, ignore_errors=True)
        raise
    if keep_last is not None:
        _prune_old(directory, keep_last)
    return final


def latest_step(directory: str) -> int | None:
    if not os.path.isdir(directory):
        return None
    entries = _step_entries(directory)
    return entries[-1][0] if entries else None


def restore(directory: str, template, step: int | None = None,
            rows: slice | None = None):
    """Restore into the structure of ``template`` (leaves need only a
    ``.shape``).  Returns ``(tree, step, metadata)`` with CPU tensor
    leaves in the stored dtypes; checkpoint leaves the template does not
    name are not read.  ``rows`` reads only those rows of every leaf's
    leading dim (a node-sharded rank's rows of the stacked state; a scalar
    whole): the template's shapes stay whole, the leaves hold the rows."""
    step = step if step is not None else latest_step(directory)
    if step is None:
        raise FileNotFoundError(f"no checkpoints under {directory}")
    path = os.path.join(directory, f"step_{step:08d}")
    with open(os.path.join(path, "meta.msgpack"), "rb") as f:
        meta = _msgpack.unpackb(f.read())
    dtypes = meta.get("dtypes", {})
    npz = os.path.join(path, "arrays.npz")

    def check(key, stored, leaf):
        if tuple(stored) != tuple(leaf.shape):
            raise ValueError(f"shape mismatch for {key}: ckpt "
                             f"{tuple(stored)} vs template "
                             f"{tuple(leaf.shape)}")

    if rows is not None:
        with zipfile.ZipFile(npz) as zf:
            def read_rows(key, leaf):
                arr, whole = _read_rows(zf, key, rows)
                check(key, whole, leaf)
                return _decode(arr, dtypes.get(key))

            tree = _map_with_paths(read_rows, template)
        return tree, step, meta["metadata"]
    with np.load(npz) as arrays:
        def read(key, leaf):
            arr = arrays[key]
            check(key, arr.shape, leaf)
            return _decode(arr, dtypes.get(key))

        tree = _map_with_paths(read, template)
    return tree, step, meta["metadata"]
