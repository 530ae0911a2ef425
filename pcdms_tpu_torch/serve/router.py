"""Per-shape service router (counterpart of ``pcdms_tpu/serve/router.py``):
one front end over N fixed-shape engines.

Each :class:`~pcdms_tpu_torch.serve.stage2.Stage2Service` /
``CascadeService`` serves ONE (height, width, num_steps, scheduler)
configuration, warmed at startup for every batch bucket of its engine. A
request stream with mixed resolutions or step counts is served by one
engine per configuration, with requests routed by shape, which is what
this router does (as the JAX package's).

``ShapeRouter`` exposes the same ``submit()/stats()/close()`` surface the
HTTP front end (``serve/http.py`` ``make_handler``) binds to, so a
multi-resolution deployment is::

    router = ShapeRouter([svc_256, svc_512])
    ServingServer(router, port=8000).serve_forever()

Requests whose canvas matches no registered service are rejected with
``ValueError`` -> HTTP 400 (not queued, and no engine sees them).
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np


class ShapeRouter:
    """Route each request to the service compiled for its canvas shape.

    ``services``: fixed-shape services exposing ``height``/``width``
    attributes (both Stage2Service and CascadeService do). Keyed by the
    (H, 2W) canvas shape of the ``vae_image`` every request carries;
    registering two services with the same canvas is an error.
    """

    def __init__(self, services: Sequence):
        if not services:
            raise ValueError("need at least one service to route to")
        self._by_canvas = {}
        for svc in services:
            key = (svc.height, 2 * svc.width)
            if key in self._by_canvas:
                raise ValueError(
                    f"duplicate service for canvas {key[0]}x{key[1]}; "
                    "mixed step counts / schedulers at one resolution "
                    "need separate routers (or ports)")
            self._by_canvas[key] = svc

    @property
    def canvases(self):
        """Registered (H, 2W) canvas shapes, sorted."""
        return sorted(self._by_canvas)

    def _route(self, vae_image) -> object:
        shape = np.shape(vae_image)
        key = shape[:2] if len(shape) == 3 else None
        svc = self._by_canvas.get(key)
        if svc is None:
            served = ", ".join(f"{h}x{w}" for h, w in self.canvases)
            raise ValueError(
                f"no service for canvas shape {shape}; this deployment "
                f"serves fixed canvases [{served}] (one warmed engine per "
                "canvas, see serve/router.py)")
        return svc

    def submit(self, *, vae_image, timeout: Optional[float] = None,
               **inputs):
        """Route by ``vae_image`` canvas; all other inputs pass through
        to the matched service's own validation."""
        svc = self._route(vae_image)
        return svc.submit(vae_image=vae_image, timeout=timeout, **inputs)

    def stats(self) -> dict:
        return {f"{h}x{w}": svc.stats()
                for (h, w), svc in sorted(self._by_canvas.items())}

    def close(self, drain: bool = True):
        for svc in self._by_canvas.values():
            svc.close(drain=drain)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
