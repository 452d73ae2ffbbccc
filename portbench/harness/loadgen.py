"""Open-loop HTTP load for the serving cells, in a process of its own so that
its threads never take the server's GIL.

Reads one JSON line on stdin (``port``, ``seed``, ``seconds``, the traffic
file's parameters), makes the same seeded clips and plan as the harness
(``traffic.http_plan``), sends ``warmup`` requests closed-loop, prints
``ready``; then, for each ``go`` line on stdin, sends every request of
the plan at its due time (``clients`` threads, one kept-alive connection
each) as a WAV body to ``POST /score`` and prints one JSON line: per
request its due, send and reply times (s from ``go``), HTTP status, clip
and log-probs.  It ends at the end of its stdin.
"""

from __future__ import annotations

import http.client
import json
import os
import sys
import threading
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))))

from portbench.harness import traffic as gen  # noqa: E402


def _post(conn, body):
    conn.request("POST", "/score", body=body, headers={"Content-Type": "audio/wav"})
    r = conn.getresponse()
    data = r.read()
    return r.status, (json.loads(data).get("log_probs") if r.status == 200 else None)


def main() -> int:
    spec = json.loads(sys.stdin.readline())
    t, port = spec["traffic"], spec["port"]
    lengths, plan = gen.http_plan(spec["seed"], t, spec["seconds"])
    bodies = [gen.wav_bytes(x) for x in gen.clips(spec["seed"], lengths, stream=2)]
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=120)
    for k in range(int(t["warmup_requests"])):
        _post(conn, bodies[k % len(bodies)])
    conn.close()
    print("ready", flush=True)
    while sys.stdin.readline().strip() == "go":
        print(json.dumps(_send(plan, bodies, port, int(t["clients"]))), flush=True)
    return 0


def _send(plan, bodies, port, clients):
    out = [None] * len(plan)
    lock = threading.Lock()
    nxt = [0]
    t0 = time.perf_counter()

    def client():
        c = http.client.HTTPConnection("127.0.0.1", port, timeout=120)
        while True:
            with lock:
                i = nxt[0]
                nxt[0] += 1
            if i >= len(plan):
                break
            due, cid = plan[i]
            wait = t0 + due - time.perf_counter()
            if wait > 0:
                time.sleep(wait)
            sent = time.perf_counter() - t0
            try:
                status, lp = _post(c, bodies[cid])
            except Exception as e:  # noqa: BLE001 -- a reply that never came
                status, lp = -1, str(e)
                c.close()
                c = http.client.HTTPConnection("127.0.0.1", port, timeout=120)
            out[i] = [due, sent, time.perf_counter() - t0, status, cid, lp]
        c.close()

    threads = [threading.Thread(target=client) for _ in range(clients)]
    for th in threads:
        th.start()
    for th in threads:
        th.join()
    return out


if __name__ == "__main__":
    sys.exit(main())
