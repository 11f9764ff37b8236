"""One run of one cell: set-up, the window, the metrics, the check, and
the result's fields.  ``run.py`` calls :func:`run_cell` after it has
found the chips; the tests call it on the CPU at a tiny size."""
from __future__ import annotations

import dataclasses
import gc
import os
from harness import arch, check, driver, readings, spec, traffic

METRICS = spec.BENCH / "metrics"


def process_start() -> float:
    """This process's start on the ``driver.clock`` scale (the start of
    the interpreter when /proc says, else now)."""
    try:
        with open("/proc/self/stat") as f:
            start_ticks = float(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
        age = uptime - start_ticks / os.sysconf("SC_CLK_TCK")
        return driver.clock() - max(0.0, age)
    except (OSError, ValueError, IndexError):
        return driver.clock()


def reader(name: str):
    """The reader of metric ``name``: ``bench/metrics/<name>.py``'s
    ``read(records)``, which returns a number or None."""
    return spec.module(METRICS / f"{name}.py", "bench_metric").read


def metrics(bench: dict, workload: str, records: dict, trace: bool) -> dict:
    """The cell's end-to-end metrics (``trace`` False) or its per-layer
    metrics (``trace`` True), each from its reader; a metric whose
    reader finds nothing is left out."""
    out = {}
    for met in bench["per_layer" if trace else "end_to_end"]:
        if "workloads" in met and workload not in met["workloads"]:
            continue
        value = reader(met["name"])(records)
        if value is not None:
            out[met["name"]] = {"value": value, "unit": met["unit"]}
    return out


def records(run, m: dict, serve: dict, setup_s: float, tracer) -> dict:
    """What the metric readers read: plain lists and numbers."""
    return {
        "seconds": run.seconds, "end": run.end, "setup_s": setup_s,
        "lanes": int(serve["lanes"]), "page_tokens": int(serve["page_tokens"]),
        "dims": m,
        "requests": [{
            "tenant": run.mix["tenants"][r.tenant]["name"], "klass": r.klass,
            "due": r.due, "sent": r.sent, "admitted": r.admitted,
            "prompt_len": r.prompt_len, "prefill_start": r.prefill_start,
            "token_times": list(r.token_times), "finished": r.finished}
            for r in run.recs],
        "decode_steps": [(s, e, len(rows)) for s, e, rows in run.decodes],
        "spans": tracer.spans if tracer is not None else {},
        "trace": (dataclasses.asdict(tracer.trace)
                  if tracer is not None and tracer.trace is not None
                  else None),
        "program": tracer.program if tracer is not None else None,
    }


def tenant_lines(run) -> list[str]:
    lines = []
    for t, ten in enumerate(run.mix["tenants"]):
        rs = [r for r in run.recs if r.tenant == t]
        lines.append(
            f"tenant {ten['name']} ({ten['class']}): sent {len(rs)} "
            f"admitted {sum(r.admitted for r in rs)} "
            f"refused_429 {sum(not r.admitted for r in rs)} "
            f"finished {sum(r.finished is not None for r in rs)} "
            f"first_token {sum(bool(r.token_times) for r in rs)}")
        reasons: dict[str, int] = {}
        for r in rs:
            if not r.admitted:
                reasons[str(r.reason)] = reasons.get(str(r.reason), 0) + 1
        if reasons:
            lines.append(f"tenant {ten['name']} refusals: {reasons}")
    late = [r.sent - r.due for r in run.recs if r.worker is None]
    if late:
        late.sort()
        lines.append(f"generator lateness s: mean {sum(late) / len(late)} "
                     f"p95 {late[int(0.95 * (len(late) - 1))]} "
                     f"max {late[-1]} over {len(late)} open-loop sends")
    lines.append(f"window closed at {run.close} s, run ended at {run.end} s, "
                 f"ticks {run.ticks}, decode steps {len(run.decodes)}, "
                 f"prefills {len(run.prefills)}")
    return lines


def tail_lines(run, recs: dict) -> list[str]:
    """Quantiles of the window's first-token times (guaranteed class,
    from the due time) and of its gaps between tokens (all tenants)."""
    import numpy as np
    q = [50, 75, 90, 95, 99]
    ttft = readings.guaranteed_ttft_s(recs)
    gaps = []
    for r in run.recs:
        t = [x for x in r.token_times if x <= run.seconds]
        gaps += [b - a for a, b in zip(t, t[1:])]
    out = []
    for name, v in (("guaranteed ttft", ttft), ("itl", gaps)):
        if v:
            out.append(f"{name} ms over {len(v)}: " + " ".join(
                f"p{p} {1e3 * x}" for p, x in zip(q, np.percentile(v, q)))
                + f" mean {1e3 * float(np.mean(v))}")
    return out


def launch_counts() -> dict:
    """Each kernel's launches by route, from the program's registry of
    kernel entry points."""
    from repro_torch.kernels import launch_counts as counts
    return {k: c["route_launches"] for k, c in counts().items()
            if "route_launches" in c}


def failed_requests(run) -> int:
    """Guaranteed-class requests due in the window that were refused or
    had no first token when the run stopped (refused spot and elastic
    requests are admission at work, printed per tenant)."""
    return sum(1 for r in run.recs if r.klass in driver.GUARANTEED
               and r.due < run.seconds
               and (not r.admitted or not r.token_times))


def serve(bench: dict, workload: str, resolved: dict, seed: int,
          seconds: float, trace: bool, device: str, log=print) -> dict:
    """Set-up, the window, the metrics: everything of one run up to the
    judging.  Returns ``metrics``, ``device``, ``attempted``, ``failed``,
    ``breaches`` (see ``check.guarantee_breaches``), ``breakdown``
    (traced) and ``inputs``, what the reference is given; the program's
    state is freed before it returns."""
    import torch
    t_start = process_start()
    conf, mix = resolved["config"], resolved["traffic"]
    side = arch.load(conf).harness
    m = side.dims(conf)
    cfg = side.arch_config(conf)
    serve_conf = conf["serve"]
    cuda = device.startswith("cuda")
    if cuda:
        from repro_torch.kernels import build
        build.build_all()
        torch.set_num_threads(2)
    engine, pool, keys = driver.build(
        cfg, side.draw_model(m, seed, device), mix, serve_conf,
        device)
    driver.warm(engine, cfg, mix, serve_conf, device)
    sched = traffic.schedule(mix, seed, seconds)
    opened = driver.requests(mix, sched, seed, cfg.vocab_size)
    prompts = driver.worker_prompts(sched, seed, cfg.vocab_size)
    tracer = None
    if trace:
        from harness.trace import Tracer
        tracer = Tracer(seconds, torch)
        tracer.prepare()
    run = driver.Run(engine, pool, mix, keys, seconds, tracer)
    if tracer is not None:
        tracer.instrument(run)
    before = launch_counts()
    if cuda:
        torch.cuda.synchronize()
    t0 = driver.clock()
    setup_s = t0 - t_start
    run.drive(opened, sched.workers, prompts, t0)
    if cuda:
        torch.cuda.synchronize()
    after = launch_counts()
    if tracer is not None:
        tracer.finish()
    peak = torch.cuda.max_memory_allocated() if cuda else 0
    recs = records(run, m, serve_conf, setup_s, tracer)
    for line in tenant_lines(run) + tail_lines(run, recs):
        log(line)
    log("launches in the window by route: " + str({
        k: {r: n - before[k].get(r, 0) for r, n in after[k].items()}
        for k in after}))
    log(f"setup_s {setup_s} memory_peak_bytes {peak}")
    dev = {"platform": "gpu" if cuda else "cpu",
           "kind": torch.cuda.get_device_name(0) if cuda else "cpu",
           "count": int(resolved["cell"]["chips"]),
           "memory_peak_bytes": int(peak)}
    out = {"metrics": metrics(bench, workload, recs, trace), "device": dev,
           "attempted": len(run.recs), "failed": failed_requests(run),
           "breaches": check.guarantee_breaches(run),
           "breakdown": tracer.breakdown() if tracer is not None else None,
           "inputs": check.replay_inputs(run, check.sample(run, seed))}
    if trace:
        tr = recs["trace"]
        dev["busy_s"] = tr["busy_s"] if tr else 0.0
        dev["window_s"] = tr["window_s"] if tr else 0.0
        if tr:
            log(f"trace: window_s {tr['window_s']} busy_s {tr['busy_s']} "
                f"prefills {len(tr['prefill_tokens'])} decode steps "
                f"{len(tr['decode_contexts'])} kernels "
                f"{sum(tr['kernel_n'].values())}")
        prog = recs["program"]
        if prog:
            log(f"program: spans {len(prog['spans'])} counter samples "
                f"{len(prog['counters'])} dropped {prog['dropped']}; "
                f"idle by span {tr['idle_by_span'] if tr else None}")
    # the program's state goes before the reference runs
    del engine, pool, run, tracer, keys, opened, prompts, sched, recs
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    return out


def run_cell(bench: dict, workload: str, resolved: dict, seed: int,
             seconds: float, trace: bool, device: str, log=print) -> dict:
    """One run; returns the result's fields (``correct``, ``attempted``,
    ``failed``, ``metrics``, ``device``, ``compare``, and ``breakdown``
    when traced)."""
    served = serve(bench, workload, resolved, seed, seconds, trace, device,
                   log)
    inputs = served["inputs"]
    conf = resolved["config"]
    m = arch.load(conf).harness.dims(conf)
    t_ref = driver.clock()
    gaps = check.logit_gaps(inputs, m, seed, device)
    log(f"reference: {len(inputs['seqs'])} judged requests, "
        f"{gaps.get('judged', 0)} judged tokens, "
        f"{driver.clock() - t_ref} s; {gaps}")
    compare, correct = check.verdict(gaps, resolved["limits"],
                                     served["breaches"])
    out = {"correct": bool(correct), "attempted": served["attempted"],
           "failed": served["failed"], "metrics": served["metrics"],
           "device": served["device"]}
    if served["breakdown"] is not None:
        out["breakdown"] = served["breakdown"]
    out["compare"] = compare
    return out
