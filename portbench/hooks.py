"""The benchmark's own spans around the calls into the program's layers,
and the record of what the judged calls produced.

While installed, the hooks wrap the program's path entry
(``render.integrator.trace_path``), its tracer entries
(``ops.block_trace.block_closest`` / ``block_occluded``: K1/K2 and their
wrappers, and ``ops.raysort.sorted_closest``, the trace-local sort around
the later bounces' K1 waves), and the session's sample, G-buffer and
denoiser calls (``render.integrator.render_path``,
``render.aov.render_gbuffer``, ``render.denoise.denoise``). They cost
nothing outside a judged call or a traced stretch: the wrapper passes the
call through. In a judged call they keep, on the device, for a sample of
pixels drawn from the run's seed and every lane of each, the rays of every
bounce in the lanes' own order with the program's hits, the shadow ray each
bounce sent, the count of live lanes of every wave the path traced and the
ray count it returned, the session's sample image, and the denoiser's
inputs and outputs, for the check after the window. In a traced stretch
they issue the span markers (:mod:`portbench.devtrace`).
"""

from __future__ import annotations

import numpy as np
import torch

T_MAX = float(np.float32(3.4e38))  # an unbounded ray's t_max, as the program states it


class Hooks:
    def __init__(self, device, seed: int, pixels: int, lanes: int, tracer):
        self.device = device
        self.pixels = pixels  # lanes of one sample per pixel
        self.lanes = lanes  # pixels judged a call
        self.tracer = tracer
        self.gen = torch.Generator(device=device)
        self.gen.manual_seed(seed & 0x7FFFFFFFFFFFFFFF)
        self.current = None  # the judged call's record, or None
        self._path = None  # the judged path call's record while it runs
        self._sorted = 0  # inside the trace-local sort's wrapper
        self._saved = []

    # -- recording ---------------------------------------------------------
    def begin(self, index: int):
        self.current = dict(index=index, closest=[], shadow=[], live=[], denoise=[])

    def end(self) -> dict:
        rec, self.current = self.current, None
        return rec

    def _pick(self, n: int):
        """The judged lanes of a wave of ``n`` lanes: a seeded sample of
        pixels with every lane of each (lane ``p + k * pixels``)."""
        per = max(n // self.pixels, 1)
        base = torch.randint(0, min(n, self.pixels), (self.lanes,), generator=self.gen,
                             device=self.device)
        k = torch.arange(per, device=self.device) * self.pixels
        return (base[:, None] + k[None]).reshape(-1), per

    def _wave(self, origin, direction, t_max, h):
        """Record a closest wave of the judged path call, in lane order."""
        rec = self._path
        tm = t_max if t_max is not None else torch.full(
            origin.shape[:1], T_MAX, dtype=torch.float32, device=origin.device)
        if "lanes" not in rec:  # the primary wave
            rec["lanes"], rec["per_pixel"] = self._pick(origin.shape[0])
            rec["n"] = origin.shape[0]
        idx = rec["lanes"]
        rec["live"].append((tm > 0).sum())
        rec["closest"].append(dict(o=origin[idx], d=direction[idx], tm=tm[idx], t=h.t[idx],
                                   hit=h.slot[idx] >= 0, per_pixel=rec["per_pixel"]))

    def _closest(self, real):
        def closest(fat, origin, direction, t_max=None, *a, **k):
            h = real(fat, origin, direction, t_max, *a, **k)
            if self._path is not None and not self._sorted:
                self._wave(origin, direction, t_max, h)
            return h

        return closest

    def _sorted_closest(self, real):
        def sorted_closest(closest, *a, **k):
            inner = real(closest, *a, **k)

            def traced(o, d, tm=None):
                self._sorted += 1
                try:
                    h = inner(o, d, tm)
                finally:
                    self._sorted -= 1
                if self._path is not None:
                    self._wave(o, d, tm, h)
                return h

            return traced

        return sorted_closest

    def _occluded(self, real):
        def occluded(fat, origin, direction, t_max, *a, **k):
            blocked = real(fat, origin, direction, t_max, *a, **k)
            rec = self._path
            if rec is not None:
                rec["live"].append((t_max > 0).sum())
                n = rec.get("n")
                if n and origin.shape[0] % n == 0:
                    # the deferred wave: each bounce's shadow rays, n lanes a part
                    for b in range(origin.shape[0] // n):
                        idx = rec["lanes"] + b * n
                        rec["shadow"].append(dict(o=origin[idx], d=direction[idx],
                                                  tm=t_max[idx], blocked=blocked[idx]))
                else:
                    rec["stray_waves"] = rec.get("stray_waves", 0) + 1
            return blocked

        return occluded

    def _trace_path(self, real):
        def trace_path(*a, **k):
            if self.current is None:
                return real(*a, **k)
            self._path = dict(closest=[], shadow=[], live=[])
            try:
                rad, n_rays = real(*a, **k)
            finally:
                rec, self._path = self._path, None
            rec["n_rays"] = n_rays
            self.current["paths"] = self.current.get("paths", 0) + 1
            self.current.update(rec)
            return rad, n_rays

        return trace_path

    def _span(self, real, lab):
        def spanned(*a, **k):
            self.tracer.mark(lab, "begin")
            out = real(*a, **k)
            self.tracer.mark(lab, "end")
            return out

        return spanned

    def _sample(self, real):
        span = self._span(real, "sample")

        def render_path(*a, **k):
            img = span(*a, **k)
            if self.current is not None:
                self.current["image"] = img
            return img

        return render_path

    def _denoise(self, real):
        span = self._span(real, "denoise")

        def denoise(state, radiance, gbuf, cfg=None):
            new_state, img = span(state, radiance, gbuf, cfg)
            if self.current is not None:
                self.current["denoise"].append(dict(
                    state=state._asdict(), radiance=radiance, gbuf=gbuf._asdict(),
                    new_state=new_state._asdict(), image=img))
            return new_state, img

        return denoise

    # -- install / remove --------------------------------------------------
    def install(self):
        from stratum_tpu_torch.ops import block_trace, raysort
        from stratum_tpu_torch.render import aov, denoise, integrator

        for mod, name, make in (
            (block_trace, "block_closest", self._closest),
            (block_trace, "block_occluded", self._occluded),
            (raysort, "sorted_closest", self._sorted_closest),
            (integrator, "trace_path", self._trace_path),
            (integrator, "render_path", self._sample),
            (aov, "render_gbuffer", lambda r: self._span(r, "gbuffer")),
            (denoise, "denoise", self._denoise),
        ):
            real = getattr(mod, name)
            self._saved.append((mod, name, real))
            setattr(mod, name, make(real))

    def remove(self):
        for mod, name, real in reversed(self._saved):
            setattr(mod, name, real)
        self._saved = []
