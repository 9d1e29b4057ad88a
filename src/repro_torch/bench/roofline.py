"""The roofline of each dry-run record (``benchmarks/roofline.py`` in
PyTorch's package): a step's compute, memory and collective terms, each
the least time one card could take for its share.

  compute    = FLOPs / (chips × peak FLOP/s)
  memory     = HBM bytes / HBM rate
  collective = collective bytes / link rate

FLOPs and HBM bytes come from ``bench.flops`` (closed form, the
reference's arithmetic); the collective bytes from the record (a rank's,
so already per card).  The constants are an argument (:data:`V5E`, the
reference's TPU v5e; :data:`H100`, the port's card, by its data sheet:
``launch.mesh``).  The port's records count every layer, so their
``collective_bytes_in_loop`` are zero and nothing is multiplied by a
layer trip count; the reference's records (an XLA scan's body counted
once) are multiplied, as its roofline does.

Beside the reference's columns: the memory term from the parameters the
model holds (``model_params``, counted on the meta model; the hybrid's
and seamless's differ from ``param_count``), and the rank's peak bytes
(argument + temp) against the card's HBM.  Every number is analytic:
data-sheet constants and shape-only records, nothing measured.

    PYTHONPATH=src python -m repro_torch.bench.roofline \\
        [--dir artifacts/dryrun_torch] [--card h100|v5e]
"""
from __future__ import annotations

import argparse
import glob
import json
import os
from typing import Dict, List, NamedTuple, Optional

from repro_torch.bench import flops as FM
from repro_torch.configs import INPUT_SHAPES, get_config
from repro_torch.configs.base import HybridConfig
from repro_torch.launch import mesh as MESH


class Card(NamedTuple):
    name: str
    peak_flops: float       # FLOP/s, bf16 dense
    hbm_bw: float           # B/s
    link_bw: float          # B/s the collective term divides by
    hbm_bytes: Optional[float] = None


V5E = Card("TPU v5e", MESH.PEAK_FLOPS_BF16, MESH.HBM_BW, MESH.ICI_BW)
H100 = Card("NVIDIA H100 SXM", MESH.H100_PEAK_FLOPS_BF16, MESH.H100_HBM_BW,
            MESH.H100_LINK_BW, MESH.H100_HBM_BYTES)
CARDS = {"h100": H100, "v5e": V5E}


def _trip_count(cfg) -> int:
    """Trip count of the reference's dominant (layer) scan."""
    if cfg.arch_type == "hybrid":
        pat = (cfg.hybrid or HybridConfig()).pattern
        return max(cfg.n_layers // len(pat), 1)
    return max(cfg.n_layers, 1)


def analyze_record(rec: Dict, card: Card = H100) -> Optional[Dict]:
    """The reference's row of an ``ok`` record, with ``card``'s
    constants, and the port's columns (the module's docstring); None for
    any other status."""
    if rec.get("status") != "ok":
        return None
    cfg = get_config(rec["arch"])
    shape = INPUT_SHAPES[rec["shape"]]
    chips = 512 if rec["mesh"] == "2x16x16" else 256
    block_skip = rec.get("tag", "baseline") != "baseline" and \
        "skip" in rec.get("tag", "")

    flops_total = FM.step_flops(cfg, shape, block_skip=block_skip)
    t_compute = flops_total / (chips * card.peak_flops)

    hbm = FM.hbm_bytes(cfg, shape, chips=chips)
    t_memory = hbm / card.hbm_bw

    cb = rec.get("collective_bytes", {})
    cl = rec.get("collective_bytes_in_loop", {})
    if "error" in cb:
        coll = 0.0
    elif "port_collectives" in rec:         # every layer counted already
        coll = sum(cb.values())
    else:
        coll = sum(cb.values()) + _trip_count(cfg) * sum(cl.values())
    t_coll = coll / card.link_bw

    terms = {"compute": t_compute, "memory": t_memory,
             "collective": t_coll}
    dominant = max(terms, key=terms.get)
    mf = FM.model_flops_per_token(cfg)
    tokens = shape.global_batch * (shape.seq_len
                                   if shape.mode != "decode" else 1)
    model_flops = mf * tokens * (1.0 if shape.mode == "train" else 1 / 3)
    useful = model_flops / flops_total if flops_total else 0.0

    mem = rec.get("memory_analysis", {})
    temp = mem.get("temp_size_in_bytes")
    row = {
        "arch": rec["arch"], "shape": rec["shape"], "mesh": rec["mesh"],
        "tag": rec.get("tag", "baseline"),
        "chips": chips,
        "t_compute_s": t_compute, "t_memory_s": t_memory,
        "t_collective_s": t_coll,
        "dominant": dominant,
        "step_flops": flops_total,
        "model_flops": model_flops,
        "useful_frac": useful,
        "collective_bytes_dev": coll,
        "hbm_bytes_dev": hbm,
        "temp_bytes_dev": temp,
        "cost_analysis_flops": rec.get("cost_analysis", {}).get("flops"),
        "compile_s": rec.get("compile_s"),
    }
    held = rec.get("model_params")
    if held is not None:
        row["t_memory_held_s"] = FM.hbm_bytes(
            cfg, shape, chips=chips, n_params=held) / card.hbm_bw
        row["model_params"] = held
        row["param_count"] = cfg.param_count()
    arg = mem.get("argument_size_in_bytes")
    if arg is not None and temp is not None:
        row["peak_bytes_dev"] = arg + temp
        if card.hbm_bytes:
            row["peak_frac_hbm"] = (arg + temp) / card.hbm_bytes
    return row


def load_all(dir_: str, tag: str = "baseline",
             card: Card = H100) -> List[Dict]:
    out = []
    for path in sorted(glob.glob(os.path.join(dir_, "*.json"))):
        with open(path) as f:
            rec = json.load(f)
        if rec.get("tag", "baseline") != tag:
            continue
        row = analyze_record(rec, card)
        if row:
            out.append(row)
        elif rec.get("status") == "skipped":
            out.append({"arch": rec["arch"], "shape": rec["shape"],
                        "mesh": rec["mesh"], "dominant": "skipped",
                        "reason": rec.get("reason", "")})
        else:
            out.append({"arch": rec["arch"], "shape": rec["shape"],
                        "mesh": rec["mesh"], "dominant": "error"})
    return out


def _g(x, fmt: str) -> str:
    return "?" if x is None else format(x, fmt)


def fmt_table(rows: List[Dict]) -> str:
    hdr = ("| arch | shape | mesh | compute s | memory s | memory s (held) "
           "| collective s | dominant | useful | temp GB | peak GB "
           "| peak / HBM |")
    lines = [hdr, "|" + "---|" * 12]
    for r in rows:
        if r["dominant"] in ("skipped", "error"):
            lines.append(f"| {r['arch']} | {r['shape']} | {r['mesh']} | "
                         + "— | " * 5 + f"{r['dominant']} | " + "— | " * 4)
            continue
        temp, peak = r.get("temp_bytes_dev"), r.get("peak_bytes_dev")
        lines.append(
            f"| {r['arch']} | {r['shape']} | {r['mesh']} | "
            f"{r['t_compute_s']:.2e} | {r['t_memory_s']:.2e} | "
            f"{_g(r.get('t_memory_held_s'), '.2e')} | "
            f"{r['t_collective_s']:.2e} | **{r['dominant']}** | "
            f"{r['useful_frac']:.2f} | "
            f"{_g(None if temp is None else temp / 1e9, '.1f')} | "
            f"{_g(None if peak is None else peak / 1e9, '.1f')} | "
            f"{_g(r.get('peak_frac_hbm'), '.2f')} |")
    return "\n".join(lines)


def fmt_compact(rows: List[Dict]) -> str:
    """One row an arch: for each shape the bound on 16x16 and 2x16x16
    (the largest term, in seconds, and its name's first three letters:
    com(pute), mem(ory), col(lective)), and the largest peak a rank
    holds in GB."""
    shapes = ("train_4k", "prefill_32k", "decode_32k", "long_500k")
    cell = {(r["arch"], r["shape"], r["mesh"]): r for r in rows}
    lines = ["| arch | " + " | ".join(shapes) + " | peak GB |",
             "|" + "---|" * (len(shapes) + 2)]
    for arch in dict.fromkeys(r["arch"] for r in rows):
        out, peak = [], 0.0
        for shp in shapes:
            parts = []
            for mesh in ("16x16", "2x16x16"):
                r = cell.get((arch, shp, mesh))
                if r is None or r["dominant"] in ("skipped", "error"):
                    parts.append("—" if r is None else r["dominant"])
                    continue
                t = max(r["t_compute_s"], r["t_memory_s"],
                        r["t_collective_s"])
                parts.append(f"{t:.3g} {r['dominant'][:3]}")
                peak = max(peak, (r.get("peak_bytes_dev") or 0) / 1e9)
            out.append(" / ".join(parts))
        lines.append(f"| {arch} | " + " | ".join(out) + f" | {peak:.1f} |")
    return "\n".join(lines)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--dir", default="artifacts/dryrun_torch")
    ap.add_argument("--tag", default="baseline")
    ap.add_argument("--card", choices=sorted(CARDS), default="h100")
    ap.add_argument("--json", default=None)
    ap.add_argument("--compact", action="store_true",
                    help="one row an arch, both meshes in each cell")
    args = ap.parse_args(argv)
    card = CARDS[args.card]
    rows = load_all(args.dir, args.tag, card)
    print(f"analytic roofline, {card.name} constants: "
          f"{card.peak_flops:.3g} FLOP/s, {card.hbm_bw:.3g} B/s HBM, "
          f"{card.link_bw:.3g} B/s a link; nothing measured")
    print(fmt_compact(rows) if args.compact else fmt_table(rows))
    if args.json:
        with open(args.json, "w") as f:
            json.dump(rows, f, indent=1)
    ok = [r for r in rows if r["dominant"] not in ("skipped", "error")
          and r["mesh"] == "16x16"]
    if ok:
        worst = min(ok, key=lambda r: r["useful_frac"])
        most = max(ok, key=lambda r: r["t_collective_s"] / max(
            r["t_compute_s"], r["t_memory_s"], 1e-12))
        ratio = most["t_collective_s"] / max(most["t_compute_s"],
                                             most["t_memory_s"], 1e-12)
        print(f"\nworst useful-FLOP fraction: {worst['arch']} × "
              f"{worst['shape']} ({worst['useful_frac']:.2f})")
        print(f"most collective-bound: {most['arch']} × {most['shape']} "
              f"(coll/max(comp,mem) = {ratio:.2f})")


if __name__ == "__main__":
    main()
