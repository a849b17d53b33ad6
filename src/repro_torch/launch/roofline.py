"""Roofline terms of a step at the card's published rates.

The port of ``repro.launch.roofline``.  Three terms (seconds a training or
serving step), as the reference has them, with one NVIDIA H100 SXM's
rates (its data sheet, dense) in place of the TPU's:

  compute    = analytic FLOPs / (chips * peak FLOP/s for the step's dtype)
  memory     = analytic bytes / (chips * 3.35e12 B/s HBM)
  collective = collective bytes / 450e9 B/s NVLink, each way

The peak depends on the operand type: 67e12 FLOP/s for float32 (outside
the tensor cores) and 989e12 for bf16 on the tensor cores, where the
reference has a single bf16 peak.

Two fields of ``RooflineReport`` change meaning against the reference's:

  * ``counted_gflops`` (the reference's ``hlo_gflops``, XLA's
    ``cost_analysis()["flops"]``) is what
    ``torch.utils.flop_counter.FlopCounterMode`` counts over the step on
    the plain path: the products (matmul, bmm, einsum, convolution,
    attention), not the elementwise work, and nothing inside the CUDA
    kernels, which are reached through ``ctypes``;
  * ``arg_gbytes`` (the reference's ``hlo_gbytes``, XLA's bytes accessed)
    is the bytes of the step's arguments: parameters, optimizer state,
    batch, cache.

The compute and memory terms come from the analytic model
(``launch/analytic.py``), as in the reference.  The collective term reads
a ``torch.profiler`` trace recorded with ``record_shapes=True``
(``collective_bytes``) in place of HLO text.  Byte-counting convention,
the reference's:

  all-gather          result bytes            (= operand * group: wire total)
  all-reduce          result bytes            (= operand bytes)
  reduce-scatter      result bytes * group    (= operand bytes)
  all-to-all          result bytes            (full payload re-shuffled)
  collective-permute  result bytes            (a send / recv pair: the recv)

A trace records every collective as it ran, so nothing is multiplied by a
loop's trip count (the reference's ``while_trips``); ``in_scan`` stays 0.
"""

from __future__ import annotations

import dataclasses
import json

import torch

__all__ = ["HW", "collective_bytes", "roofline_terms", "RooflineReport",
           "model_flops", "format_report"]


@dataclasses.dataclass(frozen=True)
class HW:
    """One card's rates.  The defaults are NVIDIA's H100 SXM data sheet's
    (dense): ``peak_f32`` outside the tensor cores, ``peak_bf16`` on them,
    ``hbm_bw`` the device memory, ``link_bw`` NVLink each way."""
    name: str = "NVIDIA H100 80GB HBM3"
    peak_f32: float = 67e12         # FLOP/s float32, CUDA cores
    peak_bf16: float = 989e12       # FLOP/s bf16, tensor cores
    hbm_bw: float = 3.35e12         # B/s a card
    link_bw: float = 450e9          # B/s NVLink, each way
    chips: int = 1

    def peak_flops(self, dtype="bfloat16") -> float:
        """The peak for operands of ``dtype`` (a name or a torch dtype)."""
        name = str(dtype).replace("torch.", "")
        if name in ("float32", "float"):
            return self.peak_f32
        if name in ("bfloat16", "bf16"):
            return self.peak_bf16
        raise ValueError(f"no peak rate for dtype {dtype!r} on {self.name}")

    @classmethod
    def from_device(cls, device=None) -> "HW":
        """The rates of the card ``device`` names, read from
        ``torch.cuda.get_device_properties``.  A card this table has no row
        for raises: nothing falls back to another card's rates."""
        name = torch.cuda.get_device_properties(device).name
        if name not in _SKUS:
            raise ValueError(
                f"no published rates for the card {name!r}; known: "
                f"{sorted(_SKUS)} (add its row to launch/roofline.py)")
        return _SKUS[name]


# rows are added when a card is seen: an H100 PCIe or an H200 has other
# rates than the SXM part
_SKUS = {hw.name: hw for hw in (HW(),)}

_DTYPE_BYTES = {
    # a profiler event's "Input type" (the C++ type name)
    "double": 8, "float": 4, "c10::Half": 2, "c10::BFloat16": 2,
    "long int": 8, "int": 4, "short int": 2,
    "signed char": 1, "unsigned char": 1, "bool": 1,
    # record_param_comms spells the dtype as the ScalarType's name
    "Double": 8, "Float": 4, "Half": 2, "BFloat16": 2, "Long": 8, "Int": 4,
    "Short": 2, "Char": 1, "Byte": 1, "Bool": 1,
    "Float8_e4m3fn": 1, "Float8_e5m2": 1,
}

_COLLECTIVES = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
                "collective-permute")

# a backend's collective name -> the reference's kind; a send is the other
# half of a recv and is not counted twice
_KINDS = {
    "all_reduce": "all-reduce", "allreduce": "all-reduce",
    "all_gather": "all-gather", "allgather": "all-gather",
    "_allgather_base": "all-gather", "all_gather_into_tensor": "all-gather",
    "allgather_into_tensor_coalesced": "all-gather",
    "reduce_scatter": "reduce-scatter", "_reduce_scatter_base": "reduce-scatter",
    "reduce_scatter_tensor": "reduce-scatter",
    "reduce_scatter_tensor_coalesced": "reduce-scatter",
    "all_to_all": "all-to-all", "alltoall": "all-to-all",
    "alltoall_base": "all-to-all", "all_to_all_single": "all-to-all",
    "recv": "collective-permute",
}


def _trace_events(trace) -> list:
    """The events of a Chrome trace: a path, its parsed dict, or a list."""
    if isinstance(trace, (str, bytes)) or hasattr(trace, "__fspath__"):
        with open(trace) as f:
            trace = json.load(f)
    if isinstance(trace, dict):
        trace = trace.get("traceEvents", [])
    return list(trace or [])


def _numel(dims) -> int:
    n = 1
    for d in dims:
        n *= int(d)
    return n


def _comm_records(events, group_size: int) -> list:
    """(kind, result bytes by the convention, event) for every collective
    of the trace.  ``record_param_comms`` events (NCCL) carry the dtype,
    the element counts and the group size; where none is present, the
    backend's own events (``gloo:all_reduce``, ...) carry the operand's
    dims and type, and the group size is the caller's."""
    out = []
    comms = [e for e in events if e.get("name") == "record_param_comms"]
    if comms:
        for e in comms:
            a = e.get("args", {})
            kind = _KINDS.get(str(a.get("Collective name", "")))
            if kind is None:
                continue
            group = int(a.get("Group size") or group_size)
            size = _DTYPE_BYTES.get(str(a.get("dtype", "")), 0)
            result = int(a.get("Out msg nelems", 0)) * size
            if kind == "reduce-scatter":
                result *= group
            out.append((kind, result, e))
        return out
    for e in events:
        name = str(e.get("name", ""))
        backend, _, op = name.partition(":")
        if backend not in ("gloo", "nccl") or op not in _KINDS:
            continue
        kind = _KINDS[op]
        a = e.get("args", {})
        dims, types = a.get("Input Dims") or [[]], a.get("Input type") or [""]
        operand = _numel(dims[0]) * _DTYPE_BYTES.get(str(types[0]), 0)
        # the event shows the operand: the result of an all-gather is
        # group times it, of a reduce-scatter 1/group (times group: the
        # operand again)
        result = operand * group_size if kind == "all-gather" else operand
        out.append((kind, result, e))
    return out


def _group_size(group_size) -> int:
    if group_size is not None:
        return int(group_size)
    import torch.distributed as dist
    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size()
    return 1


def collective_bytes(trace, group_size: int | None = None) -> dict:
    """Sum bytes per collective kind over a ``torch.profiler`` Chrome trace
    (a path, its parsed dict or its event list) recorded with
    ``record_shapes=True``.  ``group_size``: the collectives' group where
    the trace does not say it (gloo); by default the default process
    group's size, or 1 without one."""
    records = _comm_records(_trace_events(trace), _group_size(group_size))
    out = {k: 0 for k in _COLLECTIVES}
    out["total"] = 0
    out["in_scan"] = 0
    for kind, b, _ in records:
        out[kind] += b
        out["total"] += b
    return out


@dataclasses.dataclass
class RooflineReport:
    arch: str
    shape: str
    mesh: str
    counted_gflops: float        # FlopCounterMode over the plain path
    arg_gbytes: float            # the step's arguments
    analytic_gflops: float       # analytic model, global
    analytic_gbytes: float       # analytic model, global
    coll_gbytes: float           # per-device, from the trace
    coll_breakdown: dict
    t_compute: float
    t_memory: float
    t_collective: float
    bottleneck: str
    model_gflops: float
    useful_ratio: float
    bytes_per_device: float | None = None
    note: str = ""

    def as_row(self) -> dict:
        return dataclasses.asdict(self)


def model_flops(cfg, shape, n_params_active: int, m_nodes: int = 1) -> float:
    """MODEL_FLOPS = 6*N*D for training (fwd+bwd), 2*N*D for a forward-only
    serving step (N = active params, D = tokens processed)."""
    if shape.kind == "train":
        tokens = shape.global_batch * shape.seq_len
        return 6.0 * n_params_active * tokens
    if shape.kind == "prefill":
        tokens = shape.global_batch * shape.seq_len
        return 2.0 * n_params_active * tokens
    # decode: one token per sequence
    return 2.0 * n_params_active * shape.global_batch


def roofline_terms(arch: str, shape_name: str, mesh_name: str,
                   counted_flops: float, arg_bytes: float, trace, hw: HW,
                   model_fl: float, analytic_fl: float, analytic_by: float,
                   dtype="bfloat16", note: str = "",
                   bytes_per_device: float | None = None,
                   group_size: int | None = None) -> RooflineReport:
    """Terms: compute and memory from the ANALYTIC model (global / chips *
    rate; the compute rate is ``hw``'s peak for ``dtype``), collective from
    the trace's collectives (per device / the link rate).  ``trace`` may be
    None: no collective ran."""
    coll = collective_bytes(trace or [], group_size)
    t_c = analytic_fl / (hw.chips * hw.peak_flops(dtype))
    t_m = analytic_by / (hw.chips * hw.hbm_bw)
    t_x = coll["total"] / hw.link_bw          # per-device, per-link rate
    terms = {"compute": t_c, "memory": t_m, "collective": t_x}
    bottleneck = max(terms, key=terms.get)
    return RooflineReport(
        arch=arch, shape=shape_name, mesh=mesh_name,
        counted_gflops=float(counted_flops) / 1e9,
        arg_gbytes=float(arg_bytes) / 1e9,
        analytic_gflops=analytic_fl / 1e9, analytic_gbytes=analytic_by / 1e9,
        coll_gbytes=coll["total"] / 1e9,
        coll_breakdown={k: v / 1e9 for k, v in coll.items() if k != "total"},
        t_compute=t_c, t_memory=t_m, t_collective=t_x,
        bottleneck=bottleneck,
        model_gflops=model_fl / 1e9,
        useful_ratio=(model_fl / analytic_fl) if analytic_fl else 0.0,
        bytes_per_device=bytes_per_device,
        note=note)


def format_report(r: RooflineReport) -> str:
    return (f"{r.arch:28s} {r.shape:12s} {r.mesh:6s} "
            f"aflops={r.analytic_gflops:14.1f}G abytes={r.analytic_gbytes:12.1f}G "
            f"coll={r.coll_gbytes:9.2f}G  t=(c {r.t_compute*1e3:9.3f} | "
            f"m {r.t_memory*1e3:9.3f} | x {r.t_collective*1e3:9.3f}) ms "
            f"-> {r.bottleneck:10s} useful={r.useful_ratio:6.3f} {r.note}")
