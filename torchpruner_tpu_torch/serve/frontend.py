"""``python -m torchpruner_tpu_torch serve`` — the serving endpoint,
counterpart of ``torchpruner_tpu/serve/frontend.py``.

Three front ends over one engine loop, all SIGTERM-drain-safe:

- ``--synthetic N`` — open-loop synthetic traffic (Poisson at ``--rate``,
  or deterministic ``--stagger-steps``; ``--shared-prefixes K`` draws
  prompts from K shared system prompts); prints a JSON summary line.
  ``--verify`` re-decodes every request alone through ``generate()``
  against the program set that served it and asks for equal tokens —
  the continuous-batching correctness contract.
- ``--http PORT`` — a local HTTP endpoint: ``POST /v1/generate`` with
  ``{"prompt_ids": [...], "max_new": N, "temperature": .., "top_k": ..,
  "top_p": .., "seed": ..}`` blocks until the engine finishes the request
  and returns its tokens (or answers 503 + ``Retry-After`` when the
  ``--queue-bound``ed queue is full or a drain began); ``GET /healthz``
  answers 200 only when ``ready`` (503 carrying ``draining`` /
  ``staging_swap`` / ``slo_breach``); ``GET /stats`` reports the serving
  gauges; ``POST /swap {"checkpoint": DIR}`` stages a hot-swap (202);
  ``GET /metrics`` answers the obs session's registry as Prometheus text
  (503 without a session, ``--no-obs``); ``POST /profile`` arms one
  capture window (202; 409 without a profiler — no ``--obs-dir`` — or
  with a window already open or armed).  Handler threads only touch
  host state: every CUDA call runs on the engine thread or the swap's
  staging thread.
- ``--stdin`` — one JSON request per line (same schema), results echoed
  as JSON lines; EOF drains and exits.

Runs on ``cuda`` unless ``--cpu`` is given; without a GPU and without
``--cpu`` it fails.  Telemetry as in the JAX package: an obs session
unless ``--no-obs`` (its summary table goes to stderr at exit);
``--obs-dir DIR`` writes the event stream, metrics, ledger, report and
trace there; ``--profile-every N`` opens a kernel capture window every N
decode steps (``python -m torchpruner_tpu_torch obs profile DIR``).

Examples::

    python -m torchpruner_tpu_torch serve llama3_ffn_taylor --smoke \\
        --synthetic 8 --verify
    python -m torchpruner_tpu_torch serve llama3_ffn_taylor \\
        --checkpoint runs/ckpt --page-len 16 --prefix-pages 32 \\
        --prefill-chunk 64 --shared-prefixes 2 --prefix-len 64 \\
        --synthetic 16 --verify
    python -m torchpruner_tpu_torch serve llama_tiny --cpu --http 8811
"""

from __future__ import annotations

import argparse
import json
import sys
import threading
from typing import Optional

import numpy as np
import torch

from torchpruner_tpu_torch.serve.request import (
    DRAINED,
    SHED,
    request_from_dict,
)

#: the wire-schema parse shared by HTTP and stdin
_request_from_json = request_from_dict


def _resolve_model(name: str, *, smoke: bool, seed: int,
                   checkpoint: Optional[str], device):
    """(model, params, meta): a digest-verified checkpoint when given,
    else the named preset's model (or a bare MODEL_REGISTRY name) with
    seeded init params."""
    if checkpoint:
        from torchpruner_tpu_torch.checkpoint import restore_checkpoint

        model, params, _state, _opt, meta = restore_checkpoint(
            checkpoint, device=device)
        meta = dict(meta or {})
        meta["checkpoint"] = checkpoint
        return model, params, meta
    from torchpruner_tpu_torch.core.segment import init_model
    from torchpruner_tpu_torch.experiments.presets import (
        MODEL_REGISTRY,
        preset_model,
    )

    try:
        model_name = preset_model(name, smoke=smoke)
    except KeyError as e:
        raise SystemExit(str(e))
    model = MODEL_REGISTRY[model_name][0]()
    params, _state = init_model(model, seed=seed, device=device)
    return model, params, {"model": model_name}


def http_json(handler, code: int, payload: dict,
              headers: Optional[dict] = None) -> None:
    """Write a JSON response (body + Content-Length + extra headers)."""
    body = json.dumps(payload).encode()
    handler.send_response(code)
    handler.send_header("Content-Type", "application/json")
    handler.send_header("Content-Length", str(len(body)))
    for k, v in (headers or {}).items():
        handler.send_header(k, str(v))
    handler.end_headers()
    handler.wfile.write(body)


def retry_after_s(queue_depth: int, n_slots: int) -> int:
    """The 503 Retry-After hint: roughly how many scheduling waves the
    backlog represents (queue depth over the slot-array width), floored
    at one second."""
    return max(1, int(round(queue_depth / max(1, n_slots))))


def _stats(engine) -> dict:
    import time as _time

    sched = engine.scheduler
    alloc = sched.allocator
    stats = {
        "state": engine.health_state(),
        "ts": _time.time(),
        "queue_wait_ms": sched.queue_wait_ms(),
        "swaps": engine.swaps_total,
        "queue_depth": sched.queue_depth,
        "active_slots": alloc.active_slots,
        "kv_pages_in_use": alloc.pages_in_use,
        "kv_page_budget": alloc.page_budget,
        "kv_page_occupancy": round(
            alloc.pages_in_use / max(1, alloc.page_budget), 4),
        "slot_utilization": round(
            alloc.active_slots / max(1, alloc.n_slots), 4),
        "decode_steps": engine.steps,
        "gen_tokens": engine.gen_tokens,
        "admits": sched.admitted_total,
        "evictions": alloc.total_evictions,
    }
    if alloc.prefix_enabled:
        stats["prefix"] = {
            "hits": alloc.prefix_hits,
            "misses": alloc.prefix_misses,
            "hit_tokens": alloc.prefix_hit_tokens,
            "pool_pages": alloc.prefix_pages,
            "pool_used": alloc.prefix_pool_used,
            "shared_pages": alloc.shared_pages,
            "evictions": alloc.prefix_evictions,
        }
    if engine.slo is not None:
        stats["slo"] = engine.slo.snapshot()
    return stats


def _http_server(engine, port: int, request_timeout_s: float):
    """Threaded HTTP front end on 127.0.0.1 (``port`` 0 picks a free
    one); handlers submit into the engine loop running on the main
    thread and block on the request's event."""
    from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

    class Handler(BaseHTTPRequestHandler):
        def log_message(self, *a):  # quiet access log
            pass

        def _json(self, code: int, payload: dict,
                  headers: Optional[dict] = None):
            http_json(self, code, payload, headers)

        def _text(self, code: int, body: str,
                  content_type: str = "text/plain; version=0.0.4"):
            data = body.encode()
            self.send_response(code)
            self.send_header("Content-Type", content_type)
            self.send_header("Content-Length", str(len(data)))
            self.end_headers()
            self.wfile.write(data)

        def do_GET(self):
            import time as _time

            if self.path == "/healthz":
                state = engine.health_state()
                self._json(200 if state == "ready" else 503,
                           {"ok": state == "ready", "live": True,
                            "state": state, "ts": _time.time()})
            elif self.path == "/stats":
                self._json(200, _stats(engine))
            elif self.path == "/metrics":
                # live Prometheus exposition of the obs session's
                # registry; 503 without a session
                from torchpruner_tpu_torch import obs
                from torchpruner_tpu_torch.obs.exporters import (
                    prometheus_text,
                )

                session = obs.get()
                if session is None:
                    self._text(503, "# no obs session (run with "
                                    "--obs-dir or without --no-obs)\n")
                    return
                if engine.slo is not None:
                    engine.slo.check(engine.steps)  # fresh rolling p99s
                self._text(200, prometheus_text(session.metrics))
            else:
                self._json(404, {"error": "not found"})

        def do_POST(self):
            if self.path == "/profile":
                from torchpruner_tpu_torch import obs

                armed = obs.request_profile_window()
                self._json(202 if armed else 409, {
                    "armed": armed,
                    **({} if armed else
                       {"error": "no obs session/profiler, or a window "
                                 "is already open/armed"})})
                return
            if self.path == "/swap":
                try:
                    n = int(self.headers.get("Content-Length", 0))
                    ckpt = json.loads(self.rfile.read(n))["checkpoint"]
                    engine.request_swap(str(ckpt))
                except (ValueError, KeyError, TypeError,
                        json.JSONDecodeError) as e:
                    self._json(400, {"error": str(e)})
                    return
                except RuntimeError as e:  # a swap is already staging
                    self._json(409, {"error": str(e)})
                    return
                self._json(202, {"staging": True,
                                 "swaps": engine.swaps_total})
                return
            if self.path != "/v1/generate":
                self._json(404, {"error": "not found"})
                return
            try:
                n = int(self.headers.get("Content-Length", 0))
                req = _request_from_json(json.loads(self.rfile.read(n)))
                engine.submit(req)
            except (ValueError, KeyError, TypeError,
                    json.JSONDecodeError) as e:
                self._json(400, {"error": str(e)})
                return
            if req.state == SHED:
                sched = engine.scheduler
                self._json(503, {"error": "over capacity", "state": SHED,
                                 "queue_depth": sched.queue_depth},
                           headers={"Retry-After": retry_after_s(
                               sched.queue_depth, engine.n_slots)})
                return
            if req.state == DRAINED:
                self._json(503, {"error": "draining", "state": DRAINED},
                           headers={"Retry-After": 1})
                return
            if not req.wait(timeout=request_timeout_s):
                self._json(504, {"error": "timed out", "id": req.id})
                return
            if req.state == DRAINED:  # drained after queueing
                self._json(503, {"error": "draining", "state": DRAINED,
                                 "id": req.id},
                           headers={"Retry-After": 1})
                return
            self._json(200, req.result())

    return ThreadingHTTPServer(("127.0.0.1", port), Handler)


def serve_main(argv=None) -> int:
    p = argparse.ArgumentParser(
        prog="torchpruner_tpu_torch serve",
        description="continuous-batching inference engine (PyTorch/CUDA "
                    "port): scheduler + bucketed KV allocator + chunked "
                    "prefill + prefix pages + hot-swap")
    p.add_argument("preset", help="preset name (its model is served), a "
                                  "MODEL_REGISTRY model name, or anything "
                                  "with --checkpoint")
    p.add_argument("--checkpoint", metavar="DIR",
                   help="serve this digest-verified checkpoint (either "
                        "package's format) instead of seeded init params")
    p.add_argument("--smoke", action="store_true",
                   help="the preset's miniature model variant")
    p.add_argument("--cpu", action="store_true",
                   help="run on the CPU (default: the CUDA device)")
    p.add_argument("--slots", type=int, default=4,
                   help="decode slot-array width")
    p.add_argument("--max-len", type=int, default=256,
                   help="KV positions per slot (prompt + max_new cap)")
    p.add_argument("--kv-dtype", choices=("float32", "bfloat16"),
                   default="float32",
                   help="KV-cache dtype; serve an int4/int8 checkpoint "
                        "with bfloat16, which keeps activations bf16 so "
                        "every projection reaches the dequant kernel")
    p.add_argument("--page-len", type=int, default=0,
                   help="KV page size (0 = lane-aligned default)")
    p.add_argument("--prefix-pages", type=int, default=0,
                   help="pages of the shared-prefix pool (0 = sharing "
                        "off); prompts matching a published prefix copy "
                        "whole pages instead of re-running prefill")
    p.add_argument("--prefill-chunk", type=int, default=0,
                   help="chunked-prefill width in tokens (must divide "
                        "max-len; 0 = whole-bucket prefill, or the widest "
                        "of 64/32/16/8 dividing max-len when "
                        "--prefix-pages is on)")
    p.add_argument("--prefill-cap", type=int, default=0,
                   help="per-engine-step prefill-token budget (floored at "
                        "one chunk); 0 = uncapped")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--run-dir", metavar="DIR",
                   help="where the SIGTERM drain snapshots the queue")
    p.add_argument("--slo-ttft-p99-ms", type=float, default=None,
                   help="live SLO threshold: rolling TTFT p99 (ms)")
    p.add_argument("--slo-token-p99-ms", type=float, default=None,
                   help="live SLO threshold: rolling per-token p99 (ms)")
    p.add_argument("--slo-queue-p99-ms", type=float, default=None,
                   help="live SLO threshold: rolling queue-age-at-"
                        "admission p99 (ms)")
    p.add_argument("--slo-window", type=int, default=256,
                   help="observations in the rolling SLO window")
    p.add_argument("--swap-checkpoint", metavar="DIR",
                   help="hot-swap to this checkpoint mid-run (synthetic "
                        "mode: staged after --swap-after steps)")
    p.add_argument("--swap-after", type=int, default=8,
                   help="engine steps before staging --swap-checkpoint")
    mode = p.add_mutually_exclusive_group()
    mode.add_argument("--synthetic", type=int, metavar="N",
                      help="serve N open-loop synthetic requests, print a "
                           "JSON summary, exit (the default, N = 8)")
    mode.add_argument("--http", type=int, metavar="PORT",
                      help="serve a local HTTP endpoint")
    mode.add_argument("--stdin", action="store_true",
                      help="read JSON requests from stdin")
    p.add_argument("--rate", type=float, default=0.0,
                   help="synthetic: Poisson arrival rate, requests/s "
                        "(0 = deterministic step staggering)")
    p.add_argument("--stagger-steps", type=int, default=2,
                   help="synthetic: steps between deterministic arrivals")
    p.add_argument("--prompt-lens", default="4,8,6",
                   help="synthetic: comma list of prompt lengths (cycled)"
                        "; with --shared-prefixes the SUFFIX lengths")
    p.add_argument("--shared-prefixes", type=int, default=0, metavar="K",
                   help="synthetic: prompts from K shared system prompts "
                        "(round-robin) + random suffixes; 0 = random")
    p.add_argument("--prefix-len", type=int, default=32,
                   help="synthetic: shared system-prompt length in tokens")
    p.add_argument("--sessions", type=int, default=0,
                   help="synthetic: tag requests with round-robin session "
                        "ids (with --shared-prefixes)")
    p.add_argument("--max-new", default="8,5,12",
                   help="synthetic: comma list of generation budgets")
    p.add_argument("--temperature", type=float, default=0.0,
                   help="synthetic: sampling temperature (0 = greedy)")
    p.add_argument("--verify", action="store_true",
                   help="synthetic: assert every request's tokens equal "
                        "its solo generate() decode")
    p.add_argument("--timeout", type=float, default=120.0,
                   help="http: per-request wait timeout (seconds)")
    p.add_argument("--queue-bound", type=int, default=0,
                   help="bound the waiting queue: a submission landing on "
                        "a full queue is shed (HTTP: 503 + Retry-After); "
                        "0 = unbounded")
    p.add_argument("--obs-dir", metavar="DIR",
                   help="write runtime telemetry into DIR (events, "
                        "metrics, ledger, report and trace; see `obs "
                        "report`)")
    p.add_argument("--no-obs", action="store_true",
                   help="no telemetry session (GET /metrics answers 503)")
    p.add_argument("--profile-every", type=int, default=None,
                   metavar="N",
                   help="with --obs-dir: a kernel capture window every N "
                        "decode steps (obs.profile; `obs profile "
                        "<obs-dir>` renders the table; the HTTP front "
                        "end can also arm one via POST /profile)")
    p.add_argument("--profile-steps", type=int, default=None, metavar="K",
                   help="decode steps per capture window (default 3)")
    p.add_argument("--trace-sample-every", type=int, default=None,
                   metavar="N",
                   help="request-trace exemplar policy (obs.reqtrace): "
                        "full stage detail for 1-in-N requests plus the "
                        "slowest-K per window; 1 = every request")
    p.add_argument("--tenants", metavar="JSON",
                   help="multi-tenant QoS policy table (serve.qos), e.g. "
                        "'{\"chat\": {\"priority\": \"interactive\"}, "
                        "\"batch\": {\"priority\": \"batch\", \"rate\": 4, "
                        "\"burst\": 8, \"page_quota\": 16}}'; requests opt "
                        "in via their \"tenant\" field")
    args = p.parse_args(argv)
    if args.obs_dir and args.no_obs:
        p.error("--obs-dir and --no-obs are mutually exclusive")
    if args.profile_every is not None and not args.obs_dir:
        p.error("--profile-every needs --obs-dir (the capture windows "
                "live under it)")

    # TORCHPRUNER_CHAOS env → serving faults (slow_steps_ms: the "slow
    # replica"); installs nothing when unset
    from torchpruner_tpu_torch.resilience import chaos as chaos_mod

    chaos_mod.configure(None)

    from torchpruner_tpu_torch import obs
    from torchpruner_tpu_torch.utils.device import (
        resolve_device,
        strict_fp32_matmul,
    )

    device = resolve_device("cpu" if args.cpu else None)
    if device.type == "cuda":
        strict_fp32_matmul()
    session = None
    if not args.no_obs:
        session = obs.configure(args.obs_dir,
                                profile_every=args.profile_every,
                                profile_steps=args.profile_steps)
        obs.annotate_run(experiment=f"serve:{args.preset}", kind="serve",
                         model=args.preset,
                         checkpoint=args.checkpoint or "")
    if args.trace_sample_every is not None:
        from torchpruner_tpu_torch.obs import reqtrace

        reqtrace.configure(sample_every=args.trace_sample_every)
    try:
        return _serve(p, args, device, obs)
    finally:
        if session is not None:
            obs.shutdown(print_to=sys.stderr)
            if args.obs_dir:
                print(f"telemetry written to {args.obs_dir}",
                      file=sys.stderr)


def _serve(p, args, device, obs) -> int:
    from torchpruner_tpu_torch.resilience.guards import PreemptionHandler
    from torchpruner_tpu_torch.serve.engine import ServeEngine

    qos = None
    if args.tenants:
        from torchpruner_tpu_torch.serve.qos import QoS

        try:
            qos = QoS.from_dict(json.loads(args.tenants))
        except (ValueError, TypeError, KeyError,
                json.JSONDecodeError) as e:
            p.error(f"--tenants: {e}")
    model, params, meta = _resolve_model(
        args.preset, smoke=args.smoke, seed=args.seed,
        checkpoint=args.checkpoint, device=device)
    if meta.get("quantized") and args.kv_dtype == "float32" \
            and device.type == "cuda":
        print("serve: warning: a quantized checkpoint under the f32 KV "
              "cache turns activations f32 after the first attention, "
              "and those projections skip the dequant kernel; pass "
              "--kv-dtype bfloat16", file=sys.stderr, flush=True)
    engine = ServeEngine(
        model, params, n_slots=args.slots, max_len=args.max_len,
        cache_dtype=args.kv_dtype, device=device, page_len=args.page_len,
        run_dir=args.run_dir, prefix_pages=args.prefix_pages,
        prefill_chunk=args.prefill_chunk,
        prefill_token_cap=args.prefill_cap, qos=qos,
        checkpoint_meta=meta, queue_bound=args.queue_bound,
        # a long-running HTTP server must not accumulate completed
        # requests; batch modes need them for verify and reporting
        retain_results=args.http is None)
    if args.slo_ttft_p99_ms is not None \
            or args.slo_token_p99_ms is not None \
            or args.slo_queue_p99_ms is not None:
        from torchpruner_tpu_torch.serve.slo import SLOMonitor

        def sec(ms):
            return ms / 1e3 if ms is not None else None

        engine.slo = SLOMonitor(
            ttft_p99_s=sec(args.slo_ttft_p99_ms),
            token_p99_s=sec(args.slo_token_p99_ms),
            queue_p99_s=sec(args.slo_queue_p99_ms),
            window=args.slo_window)
    # obs.span degrades to a nullcontext without a session
    with PreemptionHandler() as pre, obs.span("serve", preset=args.preset):
        if args.http is not None:
            return _run_http(engine, pre, args)
        if args.stdin:
            return _run_stdin(engine, pre, args)
        return _run_synthetic(engine, pre, args)


def _run_synthetic(engine, pre, args) -> int:
    from torchpruner_tpu_torch.serve.engine import vocab_of
    from torchpruner_tpu_torch.serve.traffic import (
        open_loop,
        shared_prefix_requests,
        synthetic_requests,
    )

    n = args.synthetic or 8
    vocab = vocab_of(engine.model)
    prompt_lens = [int(x) for x in args.prompt_lens.split(",") if x]
    max_new = [int(x) for x in args.max_new.split(",") if x]
    if args.shared_prefixes > 0:
        reqs = shared_prefix_requests(
            n, vocab=vocab, n_prefixes=args.shared_prefixes,
            prefix_len=args.prefix_len, suffix_lens=prompt_lens,
            max_new=max_new, seed=args.seed, sessions=args.sessions,
            temperature=args.temperature)
    else:
        reqs = synthetic_requests(
            n, vocab=vocab, prompt_lens=prompt_lens, max_new=max_new,
            seed=args.seed, temperature=args.temperature)
    traffic = open_loop(reqs, rate=args.rate,
                        stagger_steps=args.stagger_steps, seed=args.seed)
    if args.swap_checkpoint:
        traffic = _SwapAt(traffic, args.swap_checkpoint, args.swap_after)
    # sync line for wrappers, printed before the first admission
    print(f"serve: engine loop starting ({n} synthetic requests, "
          f"{engine.n_slots} slots, {engine.device})", file=sys.stderr,
          flush=True)
    summary = engine.run(traffic, preemption=pre)
    summary["drained_snapshot"] = len(engine.drained)
    # requests per checkpoint that served them (a swap splits the run)
    served: dict = {}
    for r in engine.results():
        key = (r.served_by or engine.programs).meta.get("checkpoint",
                                                        "init")
        served[key] = served.get(key, 0) + 1
    summary["served_by"] = served
    if args.verify:
        summary["verify_mismatches"] = verify_against_solo(engine)
        if summary["verify_mismatches"]:
            print(json.dumps(summary))
            print(f"VERIFY FAILED: {summary['verify_mismatches']} requests "
                  "diverged from solo decode", file=sys.stderr)
            return 1
    print(json.dumps(summary))
    return 0


def verify_against_solo(engine) -> int:
    """Replay every completed request alone through ``generate`` against
    the program set that served it (a hot-swap mid-run changes the
    engine's), at the engine's cache length, and count those whose
    tokens differ."""
    from torchpruner_tpu_torch.generate import generate

    mismatches = 0
    for r in engine.results():
        s = r.sampling
        P = r.served_by or engine.programs
        want = generate(
            P.model, P.params, r.prompt_ids[None], r.max_new,
            temperature=s.temperature, top_k=s.top_k, top_p=s.top_p,
            rng=torch.Generator().manual_seed(int(s.seed)),
            cache_dtype=P.cache_dtype, max_len=P.max_len,
            device=engine.device)
        got = np.asarray(r.tokens, np.int64)
        if not np.array_equal(got, want.cpu().numpy()[0][:len(got)]):
            mismatches += 1
    return mismatches


class _SwapAt:
    """Traffic wrapper staging a hot-swap after N engine steps."""

    def __init__(self, inner, checkpoint: str, after_steps: int):
        self.inner, self.checkpoint = inner, checkpoint
        self.after_steps, self.fired = after_steps, False

    @property
    def exhausted(self):
        return self.inner.exhausted

    def drain(self):
        return self.inner.drain()

    def pump(self, engine):
        n = self.inner.pump(engine)
        if not self.fired and engine.steps >= self.after_steps:
            engine.request_swap(self.checkpoint)
            self.fired = True
        return n


def _run_stdin(engine, pre, args) -> int:
    for line in sys.stdin:
        line = line.strip()
        if not line:
            continue
        try:
            engine.submit(_request_from_json(json.loads(line)))
        except (ValueError, KeyError, TypeError,
                json.JSONDecodeError) as e:
            print(json.dumps({"error": str(e)}), flush=True)
    summary = engine.run(preemption=pre)
    for r in engine.results():
        print(json.dumps(r.result()), flush=True)
    print(json.dumps(summary), file=sys.stderr)
    return 0


def _run_http(engine, pre, args) -> int:
    server = _http_server(engine, args.http, args.timeout)
    stop = threading.Event()
    t = threading.Thread(target=server.serve_forever, daemon=True)
    t.start()
    print(f"serving on http://127.0.0.1:{server.server_address[1]} "
          f"(POST /v1/generate /swap /profile, GET /healthz /stats "
          f"/metrics)",
          file=sys.stderr, flush=True)
    summary = None
    try:
        # the engine loop owns the main thread; SIGTERM drains in-flight
        # requests, snapshots the queue, and returns
        summary = engine.run(preemption=pre, stop_event=stop)
    finally:
        server.shutdown()
        t.join(timeout=5)
    if summary is None:
        summary = engine.summary()
    if engine.device.type == "cuda":
        # the replica's footprint on a card it may share (fleet replicas)
        summary["max_memory_allocated"] = torch.cuda.max_memory_allocated(
            engine.device)
    print(json.dumps(summary), file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(serve_main())
