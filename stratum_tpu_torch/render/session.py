"""RenderSession: the frame-loop state (counterpart of
stratum_tpu/render/session.py). ``step()`` advances progressive samples
(batched through ``render_path_batched``, or as extra wavefront lanes
through ``render_path_lanes``), ``step_adaptive()`` spends variance-guided
rounds, ``frame()`` adds the SVGF denoiser on the current G-buffer, and a
camera move restarts the accumulation while the denoiser keeps its history
for reprojection. A checkpoint holds the accumulation and the RNG seed
counter under the reference's ``.npz`` keys, so either package resumes the
other's.

The session's tensors live on the scene's device. With a device mesh
(``mesh``, ``parallel.mesh.make_mesh``) each uniform sample, the G-buffer
and the denoiser run sharded over it (``parallel/mesh.py``), one sample a
call; ``step_adaptive`` refuses a mesh, as the reference's does.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from stratum_tpu_torch.core import math as smath
from stratum_tpu_torch.render import aov as saov
from stratum_tpu_torch.render import denoise as sdenoise
from stratum_tpu_torch.render import integrator as sintegrator
from stratum_tpu_torch.render import tonemap as stonemap
from stratum_tpu_torch.utils import profiler as sprof


@dataclasses.dataclass
class RenderSession:
    scene: object
    view: object
    cfg: sintegrator.RenderConfig
    denoise: bool = False
    denoise_cfg: sdenoise.DenoiseConfig = dataclasses.field(
        default_factory=sdenoise.DenoiseConfig
    )
    mesh: object = None  # a parallel.mesh.Mesh: samples, G-buffer and denoiser sharded
    use_restir: bool = False  # ReSTIR DI + an indirect-only path sample
    restir_candidates: int = 4
    restir_spatial_taps: int = 0
    restir_hash_jitter: bool = False  # tangent-plane jitter of the spatial taps
    # > 1: step(n) traces groups of this many samples as extra wavefront
    # lanes (render_path_lanes); memory grows with it
    spp_lanes: int = 0

    accum: torch.Tensor = None  # f32 [H, W, 3] radiance sum
    spp: int = 0
    seed0: int = 0
    # adaptive sampling (step_adaptive): per-pixel sample counts and
    # luminance^2 sums, None until the first adaptive round
    sample_count: torch.Tensor = None  # f32 [H*W]
    _accum_sq: torch.Tensor = None  # f32 [H*W]
    _seeds_used: int = 0  # RNG seeds consumed (uniform samples + rounds)
    prev_view: object = None
    denoise_state: sdenoise.DenoiseState = None
    restir_state: object = None  # restir.RestirState
    _gbuffer: saov.GBuffer = None
    _restir_prev_view: object = None  # the view the reservoirs were shaded with

    def __post_init__(self):
        h, w = self.cfg.height, self.cfg.width
        dev = self.scene.device
        if self.accum is None:
            self.accum = torch.zeros((h, w, 3), dtype=torch.float32, device=dev)
        if self.prev_view is None:
            self.prev_view = self.view
        if self.denoise_state is None:
            self.denoise_state = sdenoise.init_state(h, w, dev)
        if self.use_restir and self.restir_state is None:
            from stratum_tpu_torch.render import restir as srestir

            self.restir_state = srestir.init_restir(h * w, dev)

    # -- camera / scene changes --------------------------------------------
    def set_view(self, view):
        """Move the camera: restart the accumulation, keep the denoiser's
        history for reprojection; ReSTIR reservoirs are reprojected through
        the previous view on the next step."""
        self.prev_view = self.view
        self.view = view
        self.accum = torch.zeros_like(self.accum)
        self.spp = 0
        self._gbuffer = None
        if self.use_restir:
            self._restir_prev_view = self.prev_view

    def reset(self):
        """Full reset: accumulation, denoiser history and reservoirs."""
        dev = self.scene.device
        self.accum = torch.zeros_like(self.accum)
        self.spp = 0
        self.denoise_state = sdenoise.init_state(self.cfg.height, self.cfg.width, dev)
        self._gbuffer = None
        if self.use_restir:
            from stratum_tpu_torch.render import restir as srestir

            self.restir_state = srestir.init_restir(self.cfg.height * self.cfg.width, dev)
            self._restir_prev_view = None

    # -- stepping -----------------------------------------------------------
    def gbuffer(self) -> saov.GBuffer:
        """The current view's G-buffer, traced once per view."""
        if self._gbuffer is None:
            if self.mesh is not None:
                from stratum_tpu_torch.parallel import mesh as pmesh

                gbuf = pmesh.render_gbuffer_sharded(self.scene, self.view, self.prev_view,
                                                    self.cfg, self.mesh)
                self._gbuffer = saov.GBuffer(*(x.to(self.scene.device) for x in gbuf))
            else:
                self._gbuffer = saov.render_gbuffer(self.scene, self.view, self.prev_view,
                                                    self.cfg)
        return self._gbuffer

    def step(self, samples: int = 1):
        """Advance ``samples`` progressive samples -> the current radiance
        estimate (accumulated, not tonemapped). Several samples go through
        ``render_path_batched`` (or lane groups of ``spp_lanes`` through
        ``render_path_lanes``); with ``use_restir`` each sample is a ReSTIR
        DI frame plus an indirect-only path sample."""
        if samples > 1 and not self.use_restir and self.mesh is None:
            done = 0
            while done < samples:
                seed = self.seed0 + self._seeds_used + done
                if self.spp_lanes > 1:
                    b = min(self.spp_lanes, samples - done)
                    mean, _ = sintegrator.render_path_lanes(self.scene, self.view, self.cfg,
                                                            b, seed)
                else:
                    b = samples - done
                    mean, _ = sintegrator.render_path_batched(self.scene, self.view, self.cfg,
                                                              b, seed)
                self.accum = self.accum + mean * b
                done += b
            self.spp += samples
            self._seeds_used += samples
            if self.sample_count is not None:
                self.sample_count = self.sample_count + float(samples)
            return self.radiance()
        for _ in range(samples):
            seed = self.seed0 + self._seeds_used
            if self.use_restir:
                from stratum_tpu_torch.render import restir as srestir

                self.restir_state, direct = srestir.restir_di_jit(
                    self.scene, self.view, self.cfg, self.restir_state, seed,
                    self.restir_candidates, 20.0, self._restir_prev_view,
                    self.restir_spatial_taps, self.restir_hash_jitter,
                )
                self._restir_prev_view = None  # consumed: the state is current
                icfg = dataclasses.replace(self.cfg, indirect_only=True)
                img = direct + sintegrator.render_path(self.scene, self.view, icfg, seed)
            elif self.mesh is not None:
                from stratum_tpu_torch.parallel import mesh as pmesh

                img = pmesh.render_path_sharded(self.scene, self.view, self.cfg, seed,
                                                self.mesh).to(self.scene.device)
            else:
                img = sintegrator.render_path(self.scene, self.view, self.cfg, seed)
            self.accum = self.accum + img
            self.spp += 1
            self._seeds_used += 1
            if self.sample_count is not None:
                self.sample_count = self.sample_count + 1.0
        return self.radiance()

    def step_adaptive(self, rounds: int = 1, frac: float = 0.25):
        """Advance ``rounds`` adaptive rounds, each one fresh sample for the
        top-``frac`` pixels by smoothed marginal variance
        (render/adaptive.py). Needs a uniform ``step()`` first (the pilot);
        per-pixel counts weight the estimate."""
        if self.spp < 1:
            raise RuntimeError("step_adaptive needs a uniform pilot: call step(n) first")
        if self.use_restir or self.mesh is not None:
            raise RuntimeError("step_adaptive: unsupported with ReSTIR or a device mesh")
        from stratum_tpu_torch.render import adaptive as sadaptive

        h, w = self.cfg.height, self.cfg.width
        n = h * w
        if self.sample_count is None:
            # the uniform history becomes the pilot; its squares were not
            # kept, so a 3x3 neighbourhood variance of the mean image seeds
            # the allocation (the per-pixel means stay exact)
            cnt = float(self.spp)
            self.sample_count = torch.full((n,), cnt, dtype=torch.float32,
                                           device=self.accum.device)
            mean_img = smath.luminance(self.accum) / cnt
            pad = torch.nn.functional.pad(mean_img[None, None], (1, 1, 1, 1),
                                          mode="replicate")[0, 0]
            taps = torch.stack([pad[dy:dy + h, dx:dx + w]
                                for dy in range(3) for dx in range(3)])
            local_var = taps.var(dim=0, unbiased=False) * cnt
            self._accum_sq = (cnt * (local_var + mean_img * mean_img)).reshape(n)
        L = max(int(round(n * frac)), 1)
        accum = self.accum.reshape(n, 3)
        for _ in range(rounds):
            accum, self._accum_sq, self.sample_count = sadaptive._adaptive_round(
                self.scene, self.view, self.cfg, accum, self._accum_sq, self.sample_count, L,
                self.seed0 + self._seeds_used,
            )
            self._seeds_used += 1
        self.accum = accum.reshape(h, w, 3)
        self.spp = float(torch.mean(self.sample_count))
        return self.radiance()

    def radiance(self):
        if self.sample_count is not None:
            h, w = self.cfg.height, self.cfg.width
            return self.accum / torch.clamp(self.sample_count, min=1.0).reshape(h, w, 1)
        return self.accum / max(self.spp, 1)

    def frame(self):
        """One interactive frame: a progressive sample, then (with
        ``denoise``) the SVGF pass -> the displayable radiance."""
        span = sprof.enter("frame")
        img = self.step(1)
        if self.denoise:
            if self.mesh is not None:
                from stratum_tpu_torch.parallel import mesh as pmesh

                state, img = pmesh.denoise_sharded(self.denoise_state, self.radiance(),
                                                   self.gbuffer(), self.denoise_cfg, self.mesh)
                dev = self.scene.device
                self.denoise_state = sdenoise.DenoiseState(*(x.to(dev) for x in state))
                img = img.to(dev)
            else:
                self.denoise_state, img = sdenoise.denoise(
                    self.denoise_state, self.radiance(), self.gbuffer(), self.denoise_cfg)
        sprof.end(span)
        return img

    def tonemapped(self, mode=stonemap.TonemapMode.ACES, exposure=0.0):
        return stonemap.tonemap(self.radiance(), mode, exposure)

    # -- checkpoint / resume -------------------------------------------------
    def save_checkpoint(self, path):
        extra = {}
        if self.sample_count is not None:
            extra["sample_count"] = self.sample_count.cpu().numpy()
            extra["accum_sq"] = self._accum_sq.cpu().numpy()
        np.savez(path, accum=self.accum.cpu().numpy(), spp=self.spp, seed0=self.seed0,
                 seeds_used=self._seeds_used, **extra)

    def load_checkpoint(self, path):
        data = np.load(path if str(path).endswith(".npz") else str(path) + ".npz")
        dev = self.scene.device
        self.accum = torch.from_numpy(data["accum"]).to(dev)
        self.spp = float(data["spp"])
        if self.spp == int(self.spp):
            self.spp = int(self.spp)
        self.seed0 = int(data["seed0"])
        self._seeds_used = int(data["seeds_used"]) if "seeds_used" in data else int(self.spp)
        if "sample_count" in data:
            self.sample_count = torch.from_numpy(data["sample_count"]).to(dev)
            self._accum_sq = torch.from_numpy(data["accum_sq"]).to(dev)
