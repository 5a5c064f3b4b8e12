"""serve.daemon_p95_ms: the daemon's own 95th percentile of request
latency (``stats()["request_latency_ms"]["p95"]``, its log-bucket
histogram, from admission to completion, the warm-up requests included);
its gap to p95_ms is the front end's and the wire's."""


def read(obs):
    lat = (obs.get("daemon_stats") or {}).get("request_latency_ms") or {}
    return lat.get("p95")
