"""Benchmark harness of the port: one suite per paper table or figure, the
twin of ``benchmarks/run.py``, with its suite names.

Prints ``name,us_per_call,derived`` CSV rows on standard output (each
suite's own report goes to standard error); every suite writes its JSON
record under ``--json DIR`` (else where the suite's ``--out`` defaults).
Exits 1 if a suite failed.

  PYTHONPATH=src python -m repro_torch.bench.run [--only NAME] [--json DIR] \\
      [--smoke] [--device cpu]

Each suite runs the port's twin of the JAX script at its own defaults on
the card (``--smoke``: the twins' smoke sizes). ``lm_speedup`` runs the
JAX script's reduced GPT-2-class config (the twin's ``--smoke``), as the
JAX suite does.
"""

from __future__ import annotations

import argparse
import contextlib
import sys
import traceback
from pathlib import Path

__all__ = ["SUITES", "main"]

Row = tuple[str, float, str]


def _argv(smoke: bool, device: str | None, out: Path | None, *, smoke_flag: bool = True) -> list[str]:
    argv = ["--smoke"] if smoke and smoke_flag else []
    if device:
        argv += ["--device", device]
    if out is not None:
        argv += ["--out", str(out)]
    return argv


def flat_vs_product(smoke, device, out) -> list[Row]:  # App. J / Fig 11
    from repro_torch.bench import flat_vs_product as m

    res = m.main(_argv(smoke, device, out))
    return [(f"flat_vs_product/k={r['max_stride']}", r["flat_ms"] * 1e3,
             f"product_us={r['product_ms'] * 1e3:.1f};speedup={r['speedup']:.2f}x") for r in res["rows"]]


def block_microbench(smoke, device, out) -> list[Row]:  # App. L.5 / Table 7
    from repro_torch.bench import block_microbench as m

    res = m.main(_argv(smoke, device, out))
    rows = [(f"block_microbench/{r['pattern']}/b={r['block']}", 0.0,
             f"expected_density={r['expected_density']:.4f};actual_density={r['actual_density']:.4f}")
            for r in res["densities"]]
    lat = res["latency"]
    rows.append(("block_microbench/latency", lat["bsr_ms"] * 1e3,
                 f"dense_us={lat['dense_ms'] * 1e3:.1f};bsr_speedup={lat['bsr_speedup']:.2f}x"))
    return rows


def ntk_distance(smoke, device, out) -> list[Row]:  # Fig 4
    from repro_torch.bench import ntk_distance as m

    res = m.main(_argv(smoke, device, out, smoke_flag=False))  # CPU-sized already
    return [(f"ntk_distance/{name}", 0.0, f"rel_ntk_dist={v:.4f};density={res['density'][name]:.3f}")
            for name, v in res["rel_ntk_dist"].items()]


def vision_speedup(smoke, device, out) -> list[Row]:  # Fig 5 / Table 4
    from repro_torch.bench import vision_speedup as m

    res = m.main(_argv(smoke, device, out))
    return [(f"vision_speedup/{kind}", r["sparse"]["step_ms_median"] * 1e3,
             f"dense_us={r['dense']['step_ms_median'] * 1e3:.0f};speedup={r['speedup']:.2f}x"
             f";param_ratio={r['param_ratio']:.3f}") for kind, r in res.items()]


def lm_speedup(smoke, device, out) -> list[Row]:  # Fig 8 / Table 5
    from repro_torch.bench import lm_speedup as m

    argv = ["--smoke"] + _argv(False, device, out) + (["--steps", "1"] if smoke else [])
    r = m.main(argv)
    return [("lm_speedup/gpt2-class", r["sparse"]["step_ms_median"] * 1e3,
             f"dense_us={r['dense']['step_ms_median'] * 1e3:.0f};speedup={r['speedup']:.2f}x")]


def lra_attention(smoke, device, out) -> list[Row]:  # Fig 9 (LRA)
    from repro_torch.bench import lra_attention as m

    res = m.main(_argv(smoke, device, out))
    return [(f"lra_attention/s={r['seq']}", r["sparse_ms"] * 1e3,
             f"dense_us={r['dense_ms'] * 1e3:.0f};speedup={r['speedup']:.2f}x") for r in res["rows"]]


def roofline(smoke, device, out) -> list[Row]:  # the roofline table
    from repro_torch.bench import roofline_report

    return roofline_report.rows()


def serve_engine(smoke, device, out) -> list[Row]:  # the serving record
    from repro_torch.bench import serve_engine as m

    p = m.main(_argv(smoke, device, out))
    u, mixed, ph = p["engine_uniform"], p["engine_mixed"], p["engine_prefill_heavy"]
    base, by = p["prefill_heavy_baseline"], p["decode_by_sampler"]
    sampled = next(v for k, v in by.items() if k not in ("greedy", "sampled_vs_greedy"))
    dg, obs, live = p["dispatch_guard"], p["observability"], p["observability_live"]
    shed, prefix, good = live["slo_shed"], p["prefix_cache"], p["goodput"]
    rows = [
        ("serve_engine/uniform", 1e6 / max(u["wall_tok_s"], 1e-9),
         f"tok_s={u['tok_s']};server_tok_s={p['server']['tok_s']:.2f};speedup={p['speedup_vs_server']}x"),
        ("serve_engine/mixed", 1e6 / max(mixed["wall_tok_s"], 1e-9),
         f"tok_s={mixed['tok_s']};occupancy={mixed['mean_occupancy']};p95_ms={mixed['p95_token_latency_ms']}"),
        ("serve_engine/prefill_heavy", 1e6 / max(ph["wall_tok_s"], 1e-9),
         f"wall_tok_s={ph['wall_tok_s']};baseline={base['wall_tok_s']}"
         f";speedup={p['prefill_heavy_speedup']}x;req_per_prefill={ph['mean_prefill_batch']}"),
    ]
    rows += [(f"serve_engine/decode_{impl}", 1e6 / max(r["decode_tok_s"], 1e-9),
              f"decode_tok_s={r['decode_tok_s']};p95_ms={r['p95_token_latency_ms']}")
             for impl, r in p["decode_by_impl"].items()]
    rows += [
        ("serve_engine/decode_sampled", 1e6 / max(sampled["decode_tok_s"], 1e-9),
         f"decode_tok_s={sampled['decode_tok_s']};greedy_tok_s={by['greedy']['decode_tok_s']}"
         f";sampled_vs_greedy={by['sampled_vs_greedy']}x"),
        ("serve_engine/dispatch_guard", 1e6 * dg["steps"],
         f"steps={dg['steps']};compiles={dg['compiles']};implicit_d2h={dg['implicit_d2h']}"
         f";explicit_syncs={dg['explicit_syncs']};enforced={dg['enforced']}"),
        ("serve_engine/observability", 1e6 / max(obs["traced"]["decode_tok_s"], 1e-9),
         f"traced_tok_s={obs['traced']['decode_tok_s']};off_tok_s={obs['off']['decode_tok_s']}"
         f";traced_vs_off={obs['traced_vs_off']}x;overhead_pct={obs['overhead_pct']}"
         f";events={obs['events_recorded']}"),
        ("serve_engine/observability_live", 1e6 / max(live["monitored"]["decode_tok_s"], 1e-9),
         f"monitored_tok_s={live['monitored']['decode_tok_s']};off_tok_s={live['off']['decode_tok_s']}"
         f";monitored_vs_off={live['monitored_vs_off']}x;overhead_pct={live['overhead_pct']}"),
        ("serve_engine/slo_shed", 1e6 * (1.0 - shed["on"]["hi_attainment"] + 1e-9),
         f"hi_attainment_on={shed['on']['hi_attainment']};hi_attainment_off={shed['off']['hi_attainment']}"
         f";gain={shed['hi_attainment_gain']};sheds={shed['on']['sheds']}"
         f";critical_transitions={shed['on']['slo_transitions'].get('CRITICAL', 0)}"),
        ("serve_engine/prefix_cache", 1e6 * prefix["on"]["prefill_s"],
         f"admission_speedup={prefix['admission_speedup']}x;hit_rate={prefix['on']['hit_rate']}"
         f";wall_speedup={prefix['wall_speedup']}x"),
    ]
    rows += [(f"serve_engine/goodput_{name}", 1e6 * good[name]["on"]["ttft_p95_ms"],
              f"slo_on={good[name]['on']['slo_attainment']};slo_off={good[name]['off']['slo_attainment']}"
              f";preemptions={good[name]['on']['preemptions']};swap_out_bytes={good[name]['on']['swap_out_bytes']}")
             for name in ("burst", "long_tail")]
    rows.append(("serve_engine/goodput_chat", 1e6 * good["chat"]["ttft_p95_ms"],
                 f"turn2plus_hit_rate={good['chat']['turn2plus_hit_rate']}"
                 f";decode_indexed_pages={good['chat']['decode_indexed_pages']}"))
    return rows


SUITES = {
    "flat_vs_product": flat_vs_product,
    "block_microbench": block_microbench,
    "ntk_distance": ntk_distance,
    "vision_speedup": vision_speedup,
    "lm_speedup": lm_speedup,
    "lra_attention": lra_attention,
    "roofline": roofline,
    "serve_engine": serve_engine,
}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="the port's benchmark harness (twin of benchmarks/run.py)")
    ap.add_argument("--only", default=None, help="run one suite")
    ap.add_argument("--json", default=None, metavar="DIR",
                    help="directory for the suites' JSON records (<suite>.json)")
    ap.add_argument("--smoke", action="store_true", help="each suite at its smoke size")
    ap.add_argument("--device", default=None, help="default: the card; 'cpu' for the plain versions")
    args = ap.parse_args(argv)
    json_dir = Path(args.json) if args.json else None
    if json_dir is not None:
        json_dir.mkdir(parents=True, exist_ok=True)
    print("name,us_per_call,derived", flush=True)
    failed = 0
    for name, fn in SUITES.items():
        if args.only and args.only != name:
            continue
        out = json_dir / f"{name}.json" if json_dir is not None else None
        try:
            with contextlib.redirect_stdout(sys.stderr):
                rows = fn(args.smoke, args.device, out)
        except Exception:  # noqa: BLE001
            failed += 1
            traceback.print_exc()
            print(f"{name},0.0,FAILED", flush=True)
            continue
        for row_name, us, derived in rows:
            print(f"{row_name},{us:.1f},{derived}", flush=True)
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
