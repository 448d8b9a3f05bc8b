"""The check that decides ``correct``: what the window's judged calls
produced, against the plain reference (:mod:`portbench.reference`).

A judged call's record holds, for a seeded sample of pixels with every
lane of each, the lanes' rays of every bounce with the program's hits, the
shadow ray each bounce sent, and the image the call returned. Numbers,
each held to its limit in ``portbench/limits/<workload>.json``:

- ``untraced_calls``: judged calls in which the program traced no wave;
- ``closest_mismatch``: live lanes of the closest waves whose hit or miss
  differs from the reference's, or that meet another surface: |t - t_ref|
  / (t_ref + 1e-3 D) over a thousandth, D the diagonal of the scene's box
  (two f32 intersectors part on rays that graze a facet's edge);
- ``closest_t_gap``: the 99th percentile of that relative gap where both
  hit;
- ``shadow_mismatch``: shadow rays sent whose occlusion differs;
- ``spawn_gap``: over the lanes' hits that send a shadow ray or a next
  bounce, the largest distance from that ray's origin (the hit point,
  offset off the surface) to the reference's hit point, over D;
- ``light_gap``: over shadow rays to an emitting triangle (no longer than
  the way out of the scene's box), the largest distance from the ray's end
  to the nearest emitting triangle, over D;
- ``rays_gap``: |n_rays - the live lanes of the call's waves|;
- ``image_bad``: image values that are not finite or are negative;
- ``path_mismatch``: judged lanes whose path the reference cannot follow
  (:func:`portbench.reference.path.radiance`: a hit on another surface, a
  bounce past weights that end the path, a diffuse path stopped before
  Russian roulette);
- ``radiance_mismatch``: judged pixels, every lane of them followed, whose
  image value differs from the reference's radiance (the mean over the
  pixel's lanes) by more than ``RADIANCE_OFF``: max_c |x - x_ref| /
  (max_c |x_ref| + 1e-3);
- ``radiance_gap``: the 99th percentile of that gap over those pixels;
- in the interactive cell, at judged pixels of the G-buffer:
  ``gbuf_mismatch`` (hit or miss, instance, albedo, or inside the previous
  view, differing, or the depth off by more than a thousandth: another
  surface point), and over the other pixels ``gbuf_depth_gap`` (relative),
  ``gbuf_normal_gap`` (largest component) and ``prev_uv_gap`` (pixels);
  over the whole image ``denoise_gap`` (the largest |x - x_ref| of the
  denoised image and the new history, over the mean |x_ref| of each),
  ``denoise_l1`` (the mean |x - x_ref| over the mean |x_ref|) and
  ``tonemap_gap``. The denoiser's reference takes the G-buffer with the
  reference's own rows at the judged pixels where the two agree, the
  radiance worked out from the frames' sample images, and on the second of
  two consecutive judged frames its own history from the first.

With ``control`` the reference computed in bfloat16 takes the program's
place: its hits, shadow rays, path weights, G-buffer rows, denoiser and
tonemap are judged instead.
"""

from __future__ import annotations

import torch

from portbench.reference import geometry, intersect, path, svgf

SUMMED = ("untraced_calls", "closest_mismatch", "shadow_mismatch", "rays_gap", "image_bad",
          "gbuf_mismatch", "path_mismatch", "radiance_mismatch")
SURFACE = 1e-3  # a hit this far off (relative) is another surface point
EDGE = 1e-3  # sub-pixel distance from a pixel's edge below which a ray's pixel is ambiguous
RADIANCE_OFF = 1e-2  # a pixel's radiance this far off (relative) is another value
BF16 = torch.bfloat16


def _closest_numbers(tris, waves, control, scale):
    """-> (mismatches, t gap, live lanes judged, [gap, t_ref, t, triangle,
    barycentric distance to its nearest edge] of the widest gap's lane).
    Leaves the reference's hits in each wave (``ref_*``, ``same_surface``)."""
    mismatch, judged = 0, 0
    gaps, worst = [], None
    for w in waves:
        live = w["tm"] > 0
        t_ref, k_ref, u_ref, v_ref = intersect.closest(tris, w["o"], w["d"], w["tm"])
        hit_ref = (k_ref >= 0) & live
        if control:
            t_p, k_p, _, _ = intersect.closest(tris, w["o"], w["d"], w["tm"], BF16)
            hit_p = (k_p >= 0) & live
        else:
            t_p, hit_p = w["t"], w["hit"] & live
        both = hit_p & hit_ref
        g = torch.where(both, (t_p - t_ref).abs() / (t_ref + scale), 0.0)
        mismatch += int((live & ((hit_p != hit_ref) | (g > SURFACE))).sum())
        w.update(ref_t=torch.where(hit_ref, t_ref, float("inf")), ref_k=k_ref, ref_u=u_ref,
                 ref_v=v_ref, same_surface=(hit_p == hit_ref) & (g <= SURFACE))
        gaps.append(g[both])
        judged += int(live.sum())
        j = int(g.argmax())
        if bool(both.any()) and (worst is None or float(g[j]) > worst[0]):
            edge = min(float(u_ref[j]), float(v_ref[j]), float(1 - u_ref[j] - v_ref[j]))
            worst = [float(g[j]), float(t_ref[j]), float(t_p[j]), int(k_ref[j]), edge]
    g = torch.cat(gaps) if gaps else torch.zeros(0)
    gap = float(torch.quantile(g.double(), 0.99)) if g.numel() else 0.0
    return mismatch, gap, judged, worst


def _shadow_numbers(tris, parts, control):
    """Occlusion of the shadow rays sent; leaves ``ref_blocked`` in each
    part."""
    mismatch, judged = 0, 0
    for s in parts:
        sent = s["tm"] > 0
        ref = intersect.occluded(tris, s["o"], s["d"], s["tm"]) & sent
        prog = (intersect.occluded(tris, s["o"], s["d"], s["tm"], BF16) if control
                else s["blocked"]) & sent
        s["ref_blocked"] = ref
        mismatch += int((prog != ref).sum())
        judged += int(sent.sum())
    return mismatch, judged


def _nee_numbers(lt, waves, parts, control, diag, lo, hi):
    """(spawn_gap, light_gap) of the shadow rays sent from hits that both
    sides place on one surface. The control's shadow ray leaves the
    reference's hit point computed in bfloat16."""
    dt = BF16 if control else torch.float32
    spawn, light = 0.0, 0.0
    for w, s in zip(waves, parts):
        sent = (s["tm"] > 0) & torch.isfinite(w["ref_t"]) & w["same_surface"]
        if not bool(sent.any()):
            continue
        t_ref = torch.where(sent, w["ref_t"], 0.0)
        hit = (w["o"] + w["d"] * t_ref[:, None])[sent]
        origin = ((w["o"].to(dt) + w["d"].to(dt) * t_ref.to(dt)[:, None]).float()[sent]
                  if control else s["o"][sent])
        spawn = max(spawn, float((origin - hit).norm(dim=-1).max()) / diag)
        o, d, t = s["o"][sent], s["d"][sent], s["tm"][sent]
        end = (o.to(dt) + d.to(dt) * t.to(dt)[:, None]).float()
        area = t <= path.box_exit(o, d, lo, hi) * (1 + path.ENV_EXIT) + path.ENV_EXIT
        if bool(area.any()) and lt.tri.shape[0]:
            light = max(light, float(path.nearest_emitter(lt, end[area])[1].max()) / diag)
    return spawn, light


def _radiance_numbers(world, lt, rec, conf, cam, control, lo, hi):
    """(path_mismatch, radiance_mismatch, radiance_gap, spawn gap of the
    next bounces, pixels judged, lanes not followed by reason: another
    surface, went on, stopped)."""
    waves, parts = rec["closest"], rec["shadow"]
    rad, why, spawn = path.radiance(world, lt, waves, parts, conf["render"], lo, hi)
    per = waves[0]["per_pixel"]
    npx = rad.shape[0] // per
    ref = rad.view(npx, per, 3).mean(dim=1)
    followed = (why == 0).view(npx, per).all(dim=1)
    w0 = waves[0]
    first = slice(None, None, per)
    pix, inside = geometry.project(cam, w0["o"][first] + w0["d"][first])
    frac = pix - torch.floor(pix)
    clear = inside & ((frac > EDGE) & (frac < 1 - EDGE)).all(dim=-1)
    sel = followed & clear
    if control:  # the path's arithmetic in bfloat16 on the reference's hits
        on_ref = [dict(w, same_surface=torch.ones_like(w["same_surface"])) for w in waves]
        rad_c, why_c, _ = path.radiance(world, lt, on_ref, parts, conf["render"], lo, hi, BF16)
        prog = rad_c.view(npx, per, 3).mean(dim=1)
        sel = sel & (why_c == 0).view(npx, per).all(dim=1)
    else:
        img = rec["image"]
        x = pix[:, 0].long().clamp(0, cam.width - 1)
        y = pix[:, 1].long().clamp(0, cam.height - 1)
        prog = img[y, x].float()
    gap = (prog - ref).abs().amax(dim=-1) / (ref.abs().amax(dim=-1) + 1e-3)
    g = gap[sel]
    q = float(torch.quantile(g.double(), 0.99)) if g.numel() else 0.0
    reasons = [int((why == c).sum()) for c in (path.OTHER_SURFACE, path.WENT_ON, path.STOPPED)]
    return (int((why > 0).sum()), int((g > RADIANCE_OFF).sum()), q, spawn, int(sel.sum()),
            reasons)


def _gbuffer_numbers(world, tris, raw, conf, rec, W, H, seed, dev, control):
    """-> (numbers, pixels judged, the widest depth gap's pixel, the
    reference's rows where the two agree: (py, px, rows))."""
    den = rec["denoise"][0]
    gb = den["gbuf"]
    views = rec["views"]
    fovy = raw["camera"]["fovy"]
    cam = geometry.camera(views[1], fovy, W, H, dev)
    prev = geometry.camera(views[0] if views[0] is not None else views[1], fovy, W, H, dev)
    gen = torch.Generator(device="cpu")
    gen.manual_seed((seed * 7919 + rec["index"]) % (1 << 62))
    n = int(conf["check"]["pixels"])
    px = torch.randint(0, W, (n,), generator=gen).to(dev)
    py = torch.randint(0, H, (n,), generator=gen).to(dev)
    o, d = geometry.pixel_rays(cam, px, py)
    tm = torch.full((n,), intersect.T_MAX, device=dev)

    def rows(dtype):
        t, k, u, v = intersect.closest(tris, o, d, tm, dtype)
        r = geometry.first_hit_rows(world, t, k, u, v, d)
        hit = r["hit"]
        albedo = torch.where((~hit | r["emissive"])[:, None], 1.0, r["base_color"])
        pos = o + d * torch.where(hit, t, 0.0)[:, None]
        uv, inside = geometry.project(prev, pos, dtype)
        wh = torch.tensor([W, H], dtype=torch.float32, device=dev)
        prev_uv = torch.where((hit & inside)[:, None], uv / wh, -1.0)
        return dict(hit=hit, depth=torch.where(hit, t, float("inf")), instance=r["instance"],
                    albedo=albedo, normal=torch.where(hit[:, None], r["normal"], 0.0),
                    prev_uv=prev_uv)

    ref = rows(torch.float32)
    if control:
        prog = rows(BF16)
    else:
        prog = dict(depth=gb["depth"][py, px], instance=gb["instance"][py, px].long(),
                    albedo=gb["albedo"][py, px], normal=gb["normal"][py, px],
                    prev_uv=gb["prev_uv"][py, px])
        prog["hit"] = torch.isfinite(prog["depth"])
    both = prog["hit"] & ref["hit"]
    p_in, r_in = prog["prev_uv"][:, 0] >= 0, ref["prev_uv"][:, 0] >= 0
    depth_rel = torch.where(both, (prog["depth"] - ref["depth"]).abs() / ref["depth"], 0.0)
    wrong = ((prog["hit"] != ref["hit"]) | (both & (prog["instance"] != ref["instance"]))
             | (both & (prog["albedo"] != ref["albedo"]).any(dim=-1)) | (both & (p_in != r_in))
             | (depth_rel > SURFACE))
    j = int(depth_rel.argmax())
    worst = [float(ref["depth"][j]), float(prog["depth"][j]), int(ref["instance"][j]),
             float((d[j] * ref["normal"][j]).sum().abs())]
    out = dict(gbuf_mismatch=int(wrong.sum()), gbuf_depth_gap=0.0, gbuf_normal_gap=0.0,
               prev_uv_gap=0.0)
    both = both & ~wrong
    if bool(both.any()):
        out["gbuf_depth_gap"] = float(((prog["depth"][both] - ref["depth"][both]).abs()
                                       / ref["depth"][both]).max())
        out["gbuf_normal_gap"] = float((prog["normal"][both] - ref["normal"][both]).abs().max())
        uv_both = both & p_in & r_in
        if bool(uv_both.any()):
            out["prev_uv_gap"] = float(((prog["prev_uv"][uv_both] - ref["prev_uv"][uv_both])
                                        * torch.tensor([W, H], device=dev)).abs().max())
    agree = (py[both], px[both], {k: ref[k][both] for k in
                                  ("depth", "instance", "albedo", "normal", "prev_uv")})
    return out, n, worst, agree


def _rel_gap(p, r):
    return float((p.float() - r.float()).abs().max() / r.float().abs().mean().clamp(min=1e-20))


def _l1_gap(p, r):
    return float((p.float() - r.float()).abs().mean() / r.float().abs().mean().clamp(min=1e-20))


def _denoise_numbers(rec, agree, carried, control):
    """-> (numbers, what the next consecutive frame carries, the widest
    gap's pixel: gap, y, x, luminance, the reference's, history, the
    reference's, the mean |x_ref|). ``carried``: the previous judged
    frame's (index, spp, radiance, new state) of the reference, or None."""
    den = rec["denoise"][0]
    gbuf = {k: v.clone() for k, v in den["gbuf"].items()}
    py, px, rows = agree
    for k, v in rows.items():
        gbuf[k][py, px] = v.to(gbuf[k].dtype)
    spp, img = rec["spp"], rec["image"]
    state = den["state"]
    if carried is not None and carried[0] == rec["index"] - 1 and carried[1] == spp - 1:
        state = carried[3]
        radiance = (carried[2] * (spp - 1) + img) / spp
    elif spp == 1:
        radiance = img
    else:
        radiance = den["radiance"]
    new_ref, img_ref = svgf.denoise(state, radiance, gbuf)
    if control:
        new_p, img_p = svgf.denoise(state, radiance, gbuf, BF16)
        tm_p = svgf.aces(den["image"], BF16)
    else:
        new_p, img_p = den["new_state"], den["image"]
        tm_p = rec["tonemapped"]
    gap, l1 = _rel_gap(img_p, img_ref), _l1_gap(img_p, img_ref)
    for k in ("color", "moments", "history"):
        gap = max(gap, _rel_gap(new_p[k], new_ref[k]))
        l1 = max(l1, _l1_gap(new_p[k], new_ref[k]))
    tm_gap = float((tm_p.float() - svgf.aces(den["image"])).abs().max())
    diff = (img_p.float() - img_ref).abs().amax(dim=-1)
    j = int(diff.argmax())
    y, x = divmod(j, diff.shape[1])
    worst = [gap, y, x, float(svgf.luminance(img_p[y, x].float())),
             float(svgf.luminance(img_ref[y, x])), float(new_p["history"][y, x]),
             float(new_ref["history"][y, x]), float(img_ref.abs().mean())]
    return (dict(denoise_gap=gap, denoise_l1=l1, tonemap_gap=tm_gap),
            (rec["index"], spp, radiance, new_ref), worst)


def judge(raw, conf, records, dev, W, H, seed, control=False) -> dict:
    """-> ``per_call``: {call index: {number: value}}; ``counts``: what was
    judged, with the lane of the widest t gap (``worst_t``: gap, t_ref, t,
    the reference's triangle, its barycentric distance to an edge) and of
    the widest G-buffer depth gap (``worst_gbuf``: depth_ref, depth,
    instance, |cos| of ray and normal)."""
    world = geometry.world(raw, dev)
    lt = path.lights(world, raw["environment"], float(conf["env_probability"]))
    tris = intersect.Triangles(world.tri)
    flat = world.tri.reshape(-1, 3)
    lo, hi = flat.amin(dim=0), flat.amax(dim=0)
    diag = float((hi - lo).norm())
    scale = 1e-3 * diag
    fovy = raw["camera"]["fovy"]
    per_call, counts = {}, dict(closest_lanes=0, shadow_lanes=0, radiance_pixels=0,
                                unfollowed=[0, 0, 0], gbuf_pixels=0, calls=len(records),
                                worst_t=None)
    carried = None
    for rec in sorted(records, key=lambda r: r["index"]):
        nums = {}
        if not rec["closest"]:
            per_call[rec["index"]] = dict(untraced_calls=1)  # a judged call that traced nothing
            continue
        nums["untraced_calls"] = 0
        mm, gap, nc, worst = _closest_numbers(tris, rec["closest"], control, scale)
        if worst is not None and (counts["worst_t"] is None or gap >= counts["worst_t"][0]):
            counts["worst_t"] = worst
        sm, ns = _shadow_numbers(tris, rec["shadow"], control)
        spawn, light = _nee_numbers(lt, rec["closest"], rec["shadow"], control, diag, lo, hi)
        nums.update(closest_mismatch=mm, closest_t_gap=gap, shadow_mismatch=sm,
                    light_gap=light)
        counts["closest_lanes"] += nc
        counts["shadow_lanes"] += ns
        nums["rays_gap"] = abs(int(rec["n_rays"]) - sum(int(x) for x in rec["live"]))
        if len(rec["shadow"]) != len(rec["closest"]) or rec.get("stray_waves") \
                or rec.get("paths", 1) != 1:
            nums["path_mismatch"] = rec["closest"][0]["o"].shape[0]  # an unexpected wave layout
        img = rec["image"]
        nums["image_bad"] = int((~torch.isfinite(img) | (img < 0)).sum())
        c2w = rec["views"][1] if rec.get("views") else raw["camera"]["camera_to_world"]
        cam = geometry.camera(c2w, fovy, W, H, dev)
        if "path_mismatch" not in nums:
            pm, rm, rg, spawn_next, npx, reasons = _radiance_numbers(world, lt, rec, conf, cam,
                                                                     control, lo, hi)
            nums.update(path_mismatch=pm, radiance_mismatch=rm, radiance_gap=rg)
            spawn = max(spawn, spawn_next)
            counts["radiance_pixels"] += npx
            counts["unfollowed"] = [a + b for a, b in zip(counts["unfollowed"], reasons)]
        nums["spawn_gap"] = spawn
        if rec["denoise"]:
            g, npx, counts["worst_gbuf"], agree = _gbuffer_numbers(
                world, tris, raw, conf, rec, W, H, seed, dev, control)
            nums.update(g)
            d_nums, carried, worst_d = _denoise_numbers(rec, agree, carried, control)
            nums.update(d_nums)
            if worst_d[0] >= counts.get("worst_denoise", [-1.0])[0]:
                counts["worst_denoise"] = worst_d
            counts["gbuf_pixels"] += npx
        per_call[rec["index"]] = nums
    return dict(per_call=per_call, counts=counts)


def verdict(numbers: dict, limits: dict) -> list:
    """-> [(number, value over the judged calls, limit, within)]: counts
    summed, gaps the largest. A number the limits file names but no call
    produced is left out, as is one it lists under ``not_compared`` (no
    reading of the control separates it in that cell); one with no limit
    fails."""
    agg: dict = {}
    skip = set(limits.get("not_compared", ()))
    for nums in numbers["per_call"].values():
        for k, v in nums.items():
            if k in skip:
                continue
            agg[k] = agg.get(k, 0) + v if k in SUMMED else max(agg.get(k, 0.0), v)
    out = []
    for k, v in agg.items():
        lim = limits.get(k)
        out.append((k, v, lim, lim is not None and v <= lim))
    return out


def failed_calls(numbers: dict, limits: dict) -> int:
    skip = set(limits.get("not_compared", ()))
    return sum(1 for nums in numbers["per_call"].values()
               if any(k not in skip and (limits.get(k) is None or v > limits[k])
                      for k, v in nums.items()))
