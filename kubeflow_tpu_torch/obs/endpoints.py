"""Shared aiohttp observability endpoints (a copy of kubeflow_tpu/obs/
endpoints.py: the port imports nothing of the JAX package).

An HTTP-speaking process exposes the same two doors, `/metrics` and
`/debug/traces`: hand these factories a registry or a tracer and mount
the handler they return.

Kept in its own module, not `obs/__init__`, so importing `obs` never
pulls aiohttp into a process that serves no HTTP (the trainer).
"""

from __future__ import annotations

from aiohttp import web

from kubeflow_tpu_torch.obs.tracing import Tracer, traces_response_payload


def metrics_handler(registry):
    """GET /metrics handler over an `obs.metrics.Registry`."""

    async def render_metrics(_request: web.Request) -> web.Response:
        return web.Response(text=registry.render(),
                            content_type="text/plain")

    return render_metrics


def traces_handler(tracer: Tracer):
    """GET /debug/traces handler over a Tracer. The query contract is
    `traces_response_payload`'s; a bad `?limit=` is the caller's fault
    (400), not a crash."""

    async def debug_traces(request: web.Request) -> web.Response:
        try:
            payload = traces_response_payload(tracer,
                                              request.rel_url.query)
        except ValueError as e:
            raise web.HTTPBadRequest(text=str(e)) from None
        return web.json_response(payload)

    return debug_traces


def mount_observability(app: web.Application, *, registry,
                        tracer: Tracer) -> None:
    """Mount GET /metrics and GET /debug/traces on `app`."""
    app.router.add_get("/metrics", metrics_handler(registry))
    app.router.add_get("/debug/traces", traces_handler(tracer))
