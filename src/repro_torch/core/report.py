"""Report rendering: the paper's Table-2/3/4 layouts as markdown / CSV; a
copy of ``repro/core/report.py``, which the port does not import."""

from __future__ import annotations

import io
from typing import Dict, Iterable, List, Optional, Sequence


def to_markdown(rows: Sequence[Dict], columns: Optional[List[str]] = None,
                floatfmt: str = ".2f") -> str:
    if not rows:
        return "(empty)"
    cols = columns or list(rows[0].keys())

    def cell(v):
        if isinstance(v, float):
            return format(v, floatfmt)
        return str(v)

    widths = {c: max(len(c), *(len(cell(r.get(c, ""))) for r in rows)) for c in cols}
    out = ["| " + " | ".join(c.ljust(widths[c]) for c in cols) + " |"]
    out.append("|" + "|".join("-" * (widths[c] + 2) for c in cols) + "|")
    for r in rows:
        out.append("| " + " | ".join(cell(r.get(c, "")).ljust(widths[c]) for c in cols) + " |")
    return "\n".join(out)


def to_csv(rows: Sequence[Dict], columns: Optional[List[str]] = None) -> str:
    if not rows:
        return ""
    cols = columns or list(rows[0].keys())
    buf = io.StringIO()
    buf.write(",".join(cols) + "\n")
    for r in rows:
        buf.write(",".join(str(r.get(c, "")) for c in cols) + "\n")
    return buf.getvalue()


def table2_rows(size_reports, cache_reports_by_workload) -> List[Dict]:
    """Paper Table 2: params + cache sizes across (bsize, L) workloads."""
    rows = []
    for rep in size_reports:
        row = {"Model": rep.name, "Param.": f"{rep.param_bytes/1e9:.2f} GB"}
        for (bsize, L), cache_rep in cache_reports_by_workload.get(rep.name, {}).items():
            row[f"bsize={bsize}, L={L}"] = f"{cache_rep.total_bytes/1e9:.2f} GB"
        rows.append(row)
    return rows


def serving_summary_rows(summary: Dict) -> List[Dict]:
    """ELANA serving metrics: mean + p50/p95/p99 per latency family."""
    rows = []
    for name, label in (("ttft", "TTFT"), ("tpot", "TPOT"), ("ttlt", "TTLT")):
        if f"{name}_ms" not in summary:
            continue
        rows.append({
            "Metric": label,
            "mean(ms)": round(summary[f"{name}_ms"], 2),
            "p50(ms)": round(summary.get(f"{name}_p50_ms", 0.0), 2),
            "p95(ms)": round(summary.get(f"{name}_p95_ms", 0.0), 2),
            "p99(ms)": round(summary.get(f"{name}_p99_ms", 0.0), 2),
        })
    return rows


def serving_client_rows(summary: Dict) -> List[Dict]:
    """Client-side steady-state view (loadgen over the HTTP server):
    achieved rates, client latencies, client-vs-engine deltas, and the
    energy ledger for the measured window."""
    rows = []
    for key, label in (("steady_requests", "steady-state requests"),
                       ("steady_window_s", "window (s)"),
                       ("achieved_qps", "achieved req/s"),
                       ("client_tokens_per_sec", "client tokens/s"),
                       ("client_ttft_ms", "client TTFT mean (ms)"),
                       ("client_ttft_p95_ms", "client TTFT p95 (ms)"),
                       ("client_tpot_ms", "client TPOT mean (ms)"),
                       ("client_ttlt_ms", "client TTLT mean (ms)"),
                       ("ttft_client_minus_engine_ms",
                        "TTFT client-engine delta (ms)"),
                       ("tpot_client_minus_engine_ms",
                        "TPOT client-engine delta (ms)"),
                       ("joules_total", "window energy (J)"),
                       ("joules_attributed", "sum of request windows (J)"),
                       ("joules_per_request", "J/request"),
                       ("joules_per_token", "J/token"),
                       ("avg_watts", "avg power (W)"),
                       ("power_samples_per_sec", "power sample rate (Hz)"),
                       ("power_reads_dropped", "power reads dropped"),
                       ("warmup_excluded", "warmup requests excluded"),
                       ("errors", "client errors")):
        if key in summary:
            rows.append({"Metric": label, "value": round(summary[key], 3)})
    return rows


def serving_throughput_rows(summary: Dict) -> List[Dict]:
    """Engine-step economics: how much work each step moved and how many
    device dispatches it took (the unified mixed step targets <= 2)."""
    rows = []
    for key, label in (("tokens_per_sec", "tokens/s"),
                       ("decode_tokens_per_sec", "decode tokens/s"),
                       ("prefill_tokens_per_sec", "prefill tokens/s"),
                       ("steps_per_sec", "steps/s"),
                       ("tokens_per_dispatch", "tokens/dispatch"),
                       ("spec_accept_rate", "spec accept rate"),
                       ("drafted_tokens", "drafted tokens"),
                       ("accepted_tokens", "accepted tokens"),
                       ("power_samples_per_sec", "power sample rate (Hz)"),
                       ("power_reads_dropped", "power reads dropped")):
        if key in summary:
            rows.append({"Metric": label,
                         "value": round(summary[key], 2)})
    if "dispatches_per_step_p50" in summary:
        rows.append({"Metric": "dispatches/step p50",
                     "value": round(summary["dispatches_per_step_p50"], 2)})
        rows.append({"Metric": "dispatches/step p95",
                     "value": round(summary["dispatches_per_step_p95"], 2)})
    # per-device splits from a --tp run: list values render as a / b / c
    for key, label, fmt in (
            ("joules_per_device", "J by device", "{:.2f}"),
            ("kv_bytes_peak_per_device", "KV peak bytes by device", "{:d}"),
            ("pool_blocks_in_use_per_device", "pool blocks by device", "{:d}"),
            ("power_samples_per_sec_per_device",
             "power sample rate by device (Hz)", "{:.1f}")):
        if key in summary:
            rows.append({"Metric": label, "value": " / ".join(
                fmt.format(v) for v in summary[key])})
    return rows


def serving_request_rows(requests) -> List[Dict]:
    """Per-request table: latency + attributed energy (paper §2.4)."""
    rows = []
    for r in requests:
        rows.append({
            "Req": r.uid,
            "Prompt": len(r.prompt),
            "Out": len(r.output_tokens),
            "TTFT(ms)": round(r.ttft_s * 1e3, 1),
            "TTLT(ms)": round(r.ttlt_s * 1e3, 1),
            "J/Req": round(r.joules, 3),
            "Trunc": "y" if r.truncated else "",
        })
    return rows


def table3_rows(estimates) -> List[Dict]:
    """Paper Table 3/4: TTFT / J/Prom / TPOT / J/Tok / TTLT / J/Req."""
    rows = []
    for est in estimates:
        rows.append({
            "Model": est.arch,
            "HW": f"{est.hardware} x{est.n_devices}",
            "Workload": f"bsize={est.batch}, L={est.prompt_len}+{est.gen_len}",
            "TTFT(ms)": round(est.ttft.latency_s * 1e3, 2),
            "J/Prom.": round(est.ttft.joules, 2),
            "TPOT(ms)": round(est.tpot.latency_s * 1e3, 2),
            "J/Tok.": round(est.tpot.joules, 2),
            "TTLT(ms)": round(est.ttlt.latency_s * 1e3, 2),
            "J/Req.": round(est.ttlt.joules, 2),
        })
    return rows
