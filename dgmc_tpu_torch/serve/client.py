"""Client-side helpers: query sampling, HTTP, endpoint discovery.

The port's copy of the JAX package's ``dgmc_tpu/serve/client.py``, used
by the tests and ``chip_smoke.py`` so the load generator and the
determinism checks speak the worker's wire format. NumPy and the
standard library only: a client touches no device.
"""

import json
import os
import time
import urllib.error
import urllib.request

import numpy as np

from dgmc_tpu_torch.utils.data import Graph

__all__ = ['sample_query', 'query_payload', 'post_match', 'get_json',
           'discover_endpoint', 'confidence_of']


def sample_query(corpus_x, num_nodes, num_edges, seed=0, noise=0.6):
    """One synthetic query against a corpus feature table.

    Picks ``num_nodes`` random corpus entities, emits variance-preserving
    noisy copies of their features plus random edges among the picked
    nodes. Returns ``(Graph, gt)`` where ``gt[i]`` is the corpus index
    query node ``i`` was sampled from. Same draws as the JAX package's
    ``sample_query`` for one seed.
    """
    rng = np.random.RandomState(seed)
    n_t, dim = corpus_x.shape
    picks = rng.choice(n_t, size=num_nodes, replace=False)
    sigma = rng.uniform(0.2, noise, (num_nodes, 1)).astype(np.float32)
    eps = (rng.randn(num_nodes, dim) / np.sqrt(dim)).astype(np.float32)
    x = ((corpus_x[picks] + sigma * eps)
         / np.sqrt(1.0 + sigma ** 2)).astype(np.float32)
    snd = rng.randint(0, num_nodes, num_edges)
    rcv = rng.randint(0, num_nodes, num_edges)
    g = Graph(edge_index=np.stack([snd, rcv]).astype(np.int64), x=x)
    return g, picks.astype(np.int64)


def query_payload(graph):
    """The ``/match`` POST body for a host ``Graph``."""
    return {'nodes': np.asarray(graph.x).tolist(),
            'edges': np.asarray(graph.edge_index).T.tolist()}


def post_match(port, payload, host='127.0.0.1', timeout_s=60.0,
               traceparent=None, qtrace=None):
    """POST one query; returns ``(status_code, response_dict)`` or
    ``None`` when the endpoint is unreachable.

    ``traceparent`` propagates a W3C trace context to the worker (the
    server echoes the id back — in the payload's ``trace_id`` and the
    response ``traceparent`` header, surfaced as
    ``response['server_traceparent']``). ``qtrace=False`` sends
    ``x-qtrace: off``, opting this one request out of tracing (the
    overhead-measurement path). The client-observed wall time
    is attached as ``response['client_ms']`` so callers can account
    client-vs-server latency skew per query: ``client_ms`` minus the
    server's ``trace_ms`` is the wire + HTTP + JSON overhead the
    server-side span tree cannot see."""
    body = json.dumps(payload).encode('utf-8')
    headers = {'Content-Type': 'application/json'}
    if traceparent:
        headers['traceparent'] = traceparent
    if qtrace is False:
        headers['x-qtrace'] = 'off'
    req = urllib.request.Request(
        f'http://{host}:{int(port)}/match', data=body,
        headers=headers, method='POST')
    t0 = time.perf_counter()
    try:
        with urllib.request.urlopen(req, timeout=timeout_s) as resp:
            out = json.loads(resp.read().decode('utf-8'))
            code = resp.status
            echoed = resp.headers.get('traceparent')
    except urllib.error.HTTPError as e:
        try:
            out = json.loads(e.read().decode('utf-8'))
        except Exception:
            out = {}
        code = e.code
        echoed = e.headers.get('traceparent') if e.headers else None
    except Exception:
        return None
    if isinstance(out, dict):
        out['client_ms'] = round((time.perf_counter() - t0) * 1e3, 3)
        if echoed:
            out['server_traceparent'] = echoed
    return code, out


def confidence_of(response):
    """The per-query confidence block of a ``/match`` answer.

    Successful answers carry a ``quality`` dict beside ``stages_ms`` —
    the engine's in-graph proxies (``entropy``, ``margin``,
    ``correction``, ``saturation``, ``saturated_frac``; see the serve
    docs for semantics). Returns ``{}`` for errors and for answers from
    servers predating the quality plane, so callers can always iterate
    it."""
    if not isinstance(response, dict):
        return {}
    quality = response.get('quality')
    return dict(quality) if isinstance(quality, dict) else {}


def get_json(port, path, host='127.0.0.1', timeout_s=10.0):
    """GET a JSON (or text) endpoint; ``(code, payload)`` or ``None``."""
    url = f'http://{host}:{int(port)}{path}'
    try:
        with urllib.request.urlopen(url, timeout=timeout_s) as resp:
            body = resp.read().decode('utf-8')
            code = resp.status
    except urllib.error.HTTPError as e:
        code = e.code
        try:
            body = e.read().decode('utf-8')
        except Exception:
            return None
    except Exception:
        return None
    try:
        return code, json.loads(body)
    except ValueError:
        return code, body


def discover_endpoint(obs_root, timeout_s=0.0, poll_s=0.25):
    """Find the serving worker's live endpoint from heartbeat files.

    Scans ``obs_root`` and its ``attempt_*/`` children (the supervisor's
    per-attempt layout) for the freshest ``heartbeat.json`` advertising
    a ``port`` — the SAME discovery the supervisor's /healthz watch
    uses, so a worker whose plane moved to an ephemeral port (the
    port-in-use retry) is found at its real address. Returns
    ``(host, port, pid)`` or ``None`` after ``timeout_s``.
    """
    deadline = time.time() + timeout_s

    def scan():
        best = None
        dirs = [obs_root]
        try:
            dirs += [os.path.join(obs_root, d)
                     for d in os.listdir(obs_root)
                     if d.startswith('attempt_')]
        except OSError:
            pass
        for d in dirs:
            path = os.path.join(d, 'heartbeat.json')
            try:
                with open(path) as f:
                    hb = json.load(f)
            except (OSError, ValueError):
                continue
            if not hb.get('port'):
                continue
            if best is None or hb.get('time', 0) > best[0]:
                best = (hb.get('time', 0), hb)
        if best is None:
            return None
        hb = best[1]
        return (hb.get('host') or '127.0.0.1', int(hb['port']),
                hb.get('pid'))

    while True:
        found = scan()
        if found is not None or time.time() >= deadline:
            return found
        time.sleep(poll_s)
