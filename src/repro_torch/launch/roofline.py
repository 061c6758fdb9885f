"""Roofline terms from a dry-run trace: the JAX package's
``launch/roofline.py`` for the NVIDIA H100.

Terms (per device, seconds):
  compute    = flops / PEAK_FLOPS         (989 TFLOP/s bf16 dense)
  memory     = hbm_bytes / HBM_BW         (3.35 TB/s)
  collective = collective_bytes / LINK_BW (50 GB/s)

The constants are the H100 SXM datasheet's: 989e12 dense bf16 FLOP/s
and 3.35e12 B/s of HBM3. The link rate is one 400 Gb/s InfiniBand NDR
port a GPU: 256 H100s are 32 nodes of 8, so both 16-wide axes of the
production mesh cross nodes, and the slowest link a collective crosses
is the node's network, not NVLink.

The flops and bytes are the dry-run's per-device counts of the local
ops (``repro_torch.launch.dryrun``). Collective bytes come from the
c10d functional ops the trace records (:func:`collective_bytes`), each
counted by its local output bytes, as the reference counts the output
shapes of the collectives in its post-partitioning HLO. The reference's
HLO text parser (``shape_bytes`` and its regular expression) has no
input here: a DTensor trace makes no HLO, so it is not ported.
"""
from __future__ import annotations

import dataclasses

PEAK_FLOPS = 989e12        # bf16 dense per H100 SXM (datasheet)
HBM_BW = 3.35e12           # bytes/s per H100 SXM (datasheet)
LINK_BW = 50e9             # bytes/s: one 400 Gb/s NDR port a GPU

COLLECTIVE_KINDS = ("all-reduce", "all-gather", "reduce-scatter",
                    "all-to-all", "collective-permute")

# c10d functional op names (namespace and overload stripped) -> kind
_KIND_OF = {
    "all_reduce": "all-reduce",
    "all_reduce_": "all-reduce",
    "all_reduce_coalesced": "all-reduce",
    "all_reduce_coalesced_": "all-reduce",
    "all_gather_into_tensor": "all-gather",
    "all_gather_into_tensor_out": "all-gather",
    "all_gather_into_tensor_coalesced": "all-gather",
    "reduce_scatter_tensor": "reduce-scatter",
    "reduce_scatter_tensor_out": "reduce-scatter",
    "reduce_scatter_tensor_coalesced": "reduce-scatter",
    "all_to_all_single": "all-to-all",
}
# c10d functional ops that move no data of their own
NOT_COLLECTIVES = {"wait_tensor", "_wrap_tensor_autograd"}


def collective_kind(op_name: str) -> str | None:
    """Kind of a c10d functional op (``"all_gather_into_tensor"``), None
    for one that moves no data; raises for any other, so no collective
    is left out of the count."""
    if op_name in NOT_COLLECTIVES:
        return None
    if op_name not in _KIND_OF:
        raise ValueError(f"c10d functional op {op_name!r} has no "
                         f"collective kind")
    return _KIND_OF[op_name]


def collective_bytes(records) -> dict:
    """Sum local output bytes per collective kind over the trace's
    ``(op_name, out_bytes)`` records."""
    out = {k: 0 for k in COLLECTIVE_KINDS}
    counts = {k: 0 for k in COLLECTIVE_KINDS}
    for op_name, nbytes in records:
        kind = collective_kind(op_name)
        if kind is None:
            continue
        out[kind] += int(nbytes)
        counts[kind] += 1
    return {"bytes": out, "counts": counts,
            "total_bytes": sum(out.values())}


@dataclasses.dataclass
class RooflineTerms:
    flops: float               # per device
    hbm_bytes: float           # per device
    coll_bytes: float          # per device
    compute_s: float
    memory_s: float
    collective_s: float
    bottleneck: str
    model_flops_global: float  # 6·N·D (or 2·N·D inference)
    useful_ratio: float        # model_flops / (flops × chips)

    def as_dict(self):
        return dataclasses.asdict(self)


def derive_terms(cost: dict, coll: dict, chips: int,
                 model_flops_global: float) -> RooflineTerms:
    flops = float(cost.get("flops", 0.0) or 0.0)
    hbm = float(cost.get("bytes accessed", 0.0) or 0.0)
    cb = float(coll["total_bytes"])
    terms = {
        "compute": flops / PEAK_FLOPS,
        "memory": hbm / HBM_BW,
        "collective": cb / LINK_BW,
    }
    bottleneck = max(terms, key=terms.get)
    total = flops * chips
    return RooflineTerms(
        flops=flops, hbm_bytes=hbm, coll_bytes=cb,
        compute_s=terms["compute"], memory_s=terms["memory"],
        collective_s=terms["collective"], bottleneck=bottleneck,
        model_flops_global=model_flops_global,
        useful_ratio=(model_flops_global / total) if total else 0.0)
