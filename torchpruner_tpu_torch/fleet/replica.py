"""Replica handles: the HTTP client view and the subprocess manager.
(A copy of ``torchpruner_tpu/fleet/replica.py``; a replica runs the
port's serve CLI.)

A replica is one ``python -m torchpruner_tpu_torch serve <preset> --http``
process.  :class:`ReplicaClient` is the router's transport — generate /
healthz / stats / metrics / swap over the single-replica front end's
endpoints, with every transport failure normalized into the
:class:`ReplicaError` family so the dispatch retry loop
(``resilience.retry.with_retries``) has ONE retryable exception
surface:

- :class:`ReplicaDown` — connection refused/reset, bad socket: the
  process is (or just became) unreachable;
- :class:`ReplicaTimeout` — the socket timed out / the front end
  answered 504: alive but not answering inside the attempt budget;
- :class:`ReplicaBusy` — 503 + Retry-After: the replica's bounded
  queue shed the request (backpressure, not death);
- :class:`ReplicaRejected` — the replica answered but refused the
  request terminally for THIS replica (draining / shed mid-wait).

:class:`ReplicaProcess` adds lifecycle: spawn with its own obs dir,
``kill -9`` / SIGSTOP ("hang") / SIGCONT for the chaos drills, and
drain (SIGTERM) + wait at shutdown.
"""

from __future__ import annotations

import http.client
import json
import os
import signal
import socket
import subprocess
import sys
import time
import urllib.error
import urllib.request
from typing import List, Optional


class ReplicaError(OSError):
    """Base of every transport-level replica failure (retryable)."""


class ReplicaDown(ReplicaError):
    pass


class ReplicaTimeout(ReplicaError):
    pass


class ReplicaBusy(ReplicaError):
    def __init__(self, msg: str, retry_after_s: float = 1.0,
                 body: Optional[dict] = None):
        super().__init__(msg)
        self.retry_after_s = retry_after_s
        self.body = body or {}


class ReplicaRejected(ReplicaError):
    pass


def free_port() -> int:
    """An OS-assigned free TCP port (bind-to-0 probe; the usual small
    race with other processes is acceptable for drills/tests)."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


class ReplicaClient:
    """HTTP view of one serve replica (see module docstring)."""

    def __init__(self, name: str, port: int, host: str = "127.0.0.1"):
        self.name = name
        self.host, self.port = host, int(port)
        self.base_url = f"http://{host}:{self.port}"

    # -- raw transport ------------------------------------------------------

    def _request(self, path: str, *, data: Optional[bytes] = None,
                 timeout: Optional[float] = None) -> dict:
        req = urllib.request.Request(
            self.base_url + path, data=data,
            headers={"Content-Type": "application/json"}
            if data is not None else {})
        try:
            with urllib.request.urlopen(req, timeout=timeout) as resp:
                return json.load(resp)
        except urllib.error.HTTPError as e:
            if e.code == 503:
                try:
                    retry_after = float(e.headers.get("Retry-After", 1))
                except (TypeError, ValueError):
                    retry_after = 1.0
                try:
                    body = json.load(e)
                except Exception:
                    body = {}
                raise ReplicaBusy(
                    f"{self.name}{path}: 503 {body.get('error', '')}",
                    retry_after_s=retry_after, body=body) from e
            if e.code == 504:
                raise ReplicaTimeout(
                    f"{self.name}{path}: 504 request timed out") from e
            raise ReplicaRejected(
                f"{self.name}{path}: HTTP {e.code}") from e
        except urllib.error.URLError as e:
            if isinstance(e.reason, (socket.timeout, TimeoutError)):
                raise ReplicaTimeout(
                    f"{self.name}{path}: socket timeout") from e
            raise ReplicaDown(f"{self.name}{path}: {e.reason}") from e
        except http.client.HTTPException as e:
            # a kill -9 mid-response surfaces as IncompleteRead /
            # BadStatusLine — NOT an OSError; it MUST normalize into
            # the retryable family or the drill's exact failure mode
            # (death while the router reads the body) escapes redrive
            raise ReplicaDown(
                f"{self.name}{path}: torn response "
                f"({type(e).__name__}: {e})") from e
        except json.JSONDecodeError as e:
            raise ReplicaDown(
                f"{self.name}{path}: garbled response body") from e
        except (ConnectionError, socket.timeout, TimeoutError,
                OSError) as e:
            if isinstance(e, (socket.timeout, TimeoutError)):
                raise ReplicaTimeout(
                    f"{self.name}{path}: socket timeout") from e
            raise ReplicaDown(f"{self.name}{path}: {e}") from e

    # -- endpoints ----------------------------------------------------------

    def healthz(self, timeout: float = 2.0) -> dict:
        """``{"live": bool, "ready": bool, "state": str}`` — an HTTP
        answer of ANY kind is liveness; readiness is the front end's
        verdict (503 carries the non-ready state in its JSON body).

        When the body carries the replica's wall clock (``ts``), the
        answer additionally estimates ``clock_offset_s`` (replica −
        caller, midpoint method over this probe's request/response
        timestamps) and ``rtt_s`` — the distributed-trace alignment
        riding the probe the router already makes."""

        def offset_of(body: dict, t0: float, t1: float) -> dict:
            ts = body.get("ts")
            if ts is None:
                return {}
            return {"clock_offset_s": float(ts) - 0.5 * (t0 + t1),
                    "rtt_s": t1 - t0}

        t0 = time.time()
        try:
            out = self._request("/healthz", timeout=timeout)
            return {"live": True, "ready": bool(out.get("ok")),
                    "state": out.get("state", "ready"),
                    **offset_of(out, t0, time.time())}
        except ReplicaBusy as e:
            # 503 from /healthz = alive but NOT ready; the JSON body
            # carries the state (draining/staging_swap/slo_breach)
            return {"live": True, "ready": False,
                    "state": e.body.get("state", "not_ready"),
                    **offset_of(e.body, t0, time.time())}
        except ReplicaRejected:
            return {"live": True, "ready": False, "state": "error"}
        except (ReplicaDown, ReplicaTimeout):
            return {"live": False, "ready": False, "state": "dead"}

    def stats(self, timeout: float = 2.0) -> dict:
        return self._request("/stats", timeout=timeout)

    def generate(self, payload: dict,
                 timeout: Optional[float] = None) -> dict:
        """POST /v1/generate; returns the result dict only on a
        completed request — every other outcome is a ReplicaError the
        retry loop re-dispatches."""
        out = self._request("/v1/generate",
                            data=json.dumps(payload).encode(),
                            timeout=timeout)
        if out.get("state") != "done":
            raise ReplicaRejected(
                f"{self.name}: request ended state={out.get('state')!r}")
        return out

    def swap(self, checkpoint: str, timeout: float = 10.0) -> dict:
        return self._request(
            "/swap", data=json.dumps({"checkpoint": checkpoint}).encode(),
            timeout=timeout)


class ReplicaProcess(ReplicaClient):
    """A spawned serve subprocess + its client view."""

    def __init__(self, name: str, port: int, argv: List[str],
                 env: Optional[dict] = None, log_path: Optional[str] = None):
        super().__init__(name, port)
        self.argv = list(argv)
        self.env = dict(env) if env is not None else None
        self.log_path = log_path
        self.proc: Optional[subprocess.Popen] = None
        self._log_f = None
        self.paused = False

    def spawn(self) -> None:
        if self.log_path:
            os.makedirs(os.path.dirname(self.log_path) or ".",
                        exist_ok=True)
            self._log_f = open(self.log_path, "ab")
        self.proc = subprocess.Popen(
            self.argv, stdout=self._log_f or subprocess.DEVNULL,
            stderr=self._log_f or subprocess.DEVNULL, env=self.env)

    @property
    def alive(self) -> bool:
        return self.proc is not None and self.proc.poll() is None

    def wait_listening(self, timeout_s: float = 240.0,
                       poll_s: float = 0.25) -> bool:
        """Block until the replica answers /healthz at all (any state)
        or dies/times out — model init dominates startup; the first
        REQUEST pays the compiles."""
        deadline = time.monotonic() + timeout_s
        while time.monotonic() < deadline:
            if not self.alive:
                return False
            if self.healthz(timeout=2.0)["live"]:
                return True
            time.sleep(poll_s)
        return False

    # -- chaos / lifecycle ---------------------------------------------------

    def kill9(self) -> None:
        """The unhandleable death a preempted host actually gets."""
        if self.proc is not None and self.proc.poll() is None:
            self.proc.send_signal(signal.SIGKILL)
            self.proc.wait(timeout=30)

    def hang(self) -> None:
        """SIGSTOP: process alive, sockets unanswered — the gray
        failure liveness probes alone would miss."""
        if self.proc is not None and self.proc.poll() is None:
            self.proc.send_signal(signal.SIGSTOP)
            self.paused = True

    def resume(self) -> None:
        if self.proc is not None and self.proc.poll() is None:
            self.proc.send_signal(signal.SIGCONT)
            self.paused = False

    def drain(self, timeout_s: float = 120.0) -> Optional[int]:
        """SIGTERM (the engine's drain path) and wait; SIGKILL
        escalation on overrun.  Returns the exit code."""
        if self.proc is None:
            return None
        if self.proc.poll() is None:
            if self.paused:
                self.resume()  # a stopped process cannot run its drain
            self.proc.send_signal(signal.SIGTERM)
            try:
                self.proc.wait(timeout=timeout_s)
            except subprocess.TimeoutExpired:
                print(f"[fleet] {self.name}: drain overran "
                      f"{timeout_s:.0f}s, escalating to SIGKILL",
                      file=sys.stderr, flush=True)
                self.proc.kill()
                self.proc.wait(timeout=30)
        if self._log_f is not None:
            try:
                self._log_f.close()
            except OSError:
                pass
            self._log_f = None
        return self.proc.returncode
