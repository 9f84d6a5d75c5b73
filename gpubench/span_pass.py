"""One cell's span pass on the card: the program's spans under
torch.profiler, beside the same stretch profiled with the tracer off.

    python3 gpubench/span_pass.py --workload pl-1m.ppr-serve --seed 11 \
        --seconds 20 --out spans.json

It sets the cell up as `run.py` does. A serve cell then plays `--seconds`
of its open loop with the tracer off, reading the service's queue-wait
histogram (`serve_queue_wait_seconds`) before and after. Then the driver's
profiled stretch (jobs: the traced run's count of back-to-back jobs;
serve: 0.25 s of the stream, then 1.0 s) runs twice: under
`profile.window`, the tracer off, as `--trace 1` profiles it; and under
`spans.span_pass`, the tracer on. It prints one JSON line: the per-layer
figures the spans give (`map_device_ms`, `start_upload_ms` for a job
cell; `serve_queue_wait_ms`, `serve_prepare_ms`,
`device_starved_pct.serve` for the serve cell), the device's idle gaps by
span and the share no span or op covers, and what the tracer costs when
on: wall per iteration (jobs) and the median query latency (serve) of
both stretches. The idle gaps by span also go to standard error.
"""
import argparse
import json
import pathlib
import statistics
import sys

import numpy as np

BENCH = pathlib.Path(__file__).resolve().parent
ROOT = BENCH.parent


def stretches(driver, drv, serve: bool):
    """The driver's profiled stretch as (warm, active, latencies): the
    functions its `trace()` profiles, and the list the serve stretch's
    query latencies (s) are appended to."""
    from harness.graph import rng

    lat: list = []
    if not serve:
        jobs = max(3, min(50, int(0.25 / max(drv.job_s, 1e-6))))

        def active():
            for j in range(jobs):
                drv.job(j)
        return (lambda: drv.job(0)), active, lat, jobs * drv.iters

    def stretch(seconds: float, stream: int, keep: bool):
        N = max(1, int(round(drv.rate * seconds)))
        due = driver.arrivals(N, drv.rate, rng(int(drv.t["arrival_seed"]),
                                                 stream))
        run = drv._play(due, drv.vertices(N, rng(drv.ctx.seed, stream)), {},
                        float(drv.t["drain_s"]))
        if keep:
            lat[:] = run["lat"].tolist()
    return (lambda: stretch(0.25, 10, False),
            lambda: stretch(1.0, 11, True), lat, None)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, default=20.0,
                    help="the serve cell's open loop before the stretches")
    ap.add_argument("--out", help="also write the JSON line to this file")
    args = ap.parse_args(argv)
    sys.path[:0] = [str(BENCH), str(ROOT / "src")]

    import torch

    from harness import cell, graph, manifest, profile, spans

    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    spec = manifest.resolve(manifest.load_manifest(ROOT), args.workload,
                            ROOT, BENCH)
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    sampler = manifest.load(BENCH, "graphs", spec.config["graph"]["sampler"])
    driver = manifest.load(BENCH, "drivers", spec.traffic["driver"])
    u, v, n = sampler.edges(spec.config["graph"])
    drv = driver.Driver(cell.RunContext(spec, graph.csr_of(u, v, n),
                                        args.seed, dev))
    drv.build()
    drv.warm_up()
    serve = hasattr(drv, "svc")
    out = {"workload": spec.name, "seed": args.seed,
           "device": torch.cuda.get_device_name(dev),
           "torch": torch.__version__, "metrics": {}}
    m = out["metrics"]
    if serve:
        wait = drv.svc.stats.queue_wait
        before = (wait.sum, wait.count)
        win = drv.window(args.seconds)
        m["serve_queue_wait_ms"] = spans.queue_wait_ms(
            before, (wait.sum, wait.count))
        out["window"] = {"query_p95_ms": win["metrics"]["query_p95_ms"],
                         "serve_mean_batch": win["layer"]["serve_mean_batch"],
                         "failed": win["failed"]}

    warm, active, lat, iterations = stretches(driver, drv, serve)
    plain = profile.window(torch, warm, active)
    plain_lat = list(lat)
    lat.clear()
    st = spans.span_pass(torch, warm, active)
    if plain is None or st is None:
        print("no complete profiler window", file=sys.stderr)
        drv.close()
        return 1

    dev_recs = [(r.name, r.start, r.end) for r in st.recs
                if r.kind == "device"]
    traced = profile.Trace(dev_recs, [], st.wall_s, st.tries, {})
    gaps, idle_s, uncovered = spans.idle_gaps(st.recs)
    by_span = spans.device_s_by_span(st.recs)
    host_threads = {}
    for r in st.recs:
        if r.kind == "span":
            host_threads.setdefault(r.name, set()).add(r.thread)
    if serve:
        m["serve_prepare_ms"] = spans.prepare_ms(st.spans)
        m["device_starved_pct.serve"] = spans.starved_serve_pct(st)
        out["cost"] = {
            "plain_p50_ms": 1e3 * statistics.median(plain_lat),
            "traced_p50_ms": 1e3 * statistics.median(lat),
            "plain_wall_s": plain.wall_s, "traced_wall_s": st.wall_s}
    else:
        m["map_device_ms"] = spans.per_iteration_ms(st, "phase.map",
                                                    iterations)
        m["start_upload_ms"] = spans.per_iteration_ms(st, "engine.start",
                                                      iterations)
        out["cost"] = {"iterations": iterations,
                       "plain_wall_ms_per_iter": 1e3 * plain.wall_s / iterations,
                       "traced_wall_ms_per_iter": 1e3 * st.wall_s / iterations}
    out.update({
        "plain_idle_pct": plain.idle_pct(), "traced_idle_pct": traced.idle_pct(),
        "idle_s": idle_s, "uncovered_share": uncovered, "idle_gaps": gaps,
        "device_s_by_span": {str(k): v for k, v in sorted(
            by_span.items(), key=lambda kv: -kv[1])},
        "offset_us": st.offset_us(), "tries": [plain.tries, st.tries],
        "span_threads": {k: len(v) for k, v in sorted(host_threads.items())},
        "records": {k: sum(r.kind == k for r in st.recs)
                    for k in ("device", "runtime", "op", "span")},
        "spans": len(st.spans)})
    finite = all(isinstance(x, float) and np.isfinite(x) and x > 0
                 for x in m.values())
    out["finite_and_positive"] = finite
    print(f"span pass {spec.name}: idle {idle_s:.6f} s, uncovered share "
          f"{uncovered:.4f}; idle gaps by span: "
          + ", ".join(f"{name} {s:.6f}" for name, s in gaps), file=sys.stderr)
    drv.close()
    line = json.dumps(out)
    if args.out:
        pathlib.Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        pathlib.Path(args.out).write_text(line + "\n")
    print(line, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
