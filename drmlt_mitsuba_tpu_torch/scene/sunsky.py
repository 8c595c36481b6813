"""Analytic daylight emitters: Preetham sky + sun disk (the port's own
copy of drmlt_mitsuba_tpu/scene/sunsky.py, which is numpy; the port
imports nothing of the JAX package).

Counterpart of the `sky`, `sun` and `sunsky` plugins (src/emitters/
sky.cpp, sun.cpp, sunsky.cpp): the sky is baked once at scene load into a
lat-long radiance image and rendered as an image environment
(render/emitter.py: importance sampling, bilinear lookup, MIS).

Model: A. J. Preetham, P. Shirley, B. Smits, "A Practical Analytic Model
for Daylight" (SIGGRAPH 1999).  The sun is a uniform disk of angular
radius 0.2665 deg whose radiance is set so that its integrated irradiance
approximates the solar constant attenuated by a simple turbidity-dependent
optical mass.
"""
from __future__ import annotations

import numpy as np

SUN_APP_RADIUS_DEG = 0.2665  # ref: sun.cpp apparent solar radius

# Perez coefficients as linear functions of turbidity T (Preetham Table A.1)
_PEREZ_Y = np.array([
    [0.1787, -1.4630], [-0.3554, 0.4275], [-0.0227, 5.3251],
    [0.1206, -2.5771], [-0.0670, 0.3703],
])
_PEREZ_x = np.array([
    [-0.0193, -0.2592], [-0.0665, 0.0008], [-0.0004, 0.2125],
    [-0.0641, -0.8989], [-0.0033, 0.0452],
])
_PEREZ_y = np.array([
    [-0.0167, -0.2608], [-0.0950, 0.0092], [-0.0079, 0.2102],
    [-0.0441, -1.6537], [-0.0109, 0.0529],
])

# zenith chromaticity: [T^2, T, 1] . M . [ths^3, ths^2, ths, 1]
# Functional form per Preetham A.2.  The theta_s-linear entries of the
# constant rows are constrained so the zenith (x, y) trajectory tracks the
# measured daylight locus (blue ~(0.25, 0.26) at mid sun elevations,
# deeper blue zenith as the sun sets) — verified in
# tests/test_xml.py::TestSunsky.
_ZENITH_x = np.array([
    [0.00166, -0.00375, 0.00209, 0.0],
    [-0.02903, 0.06377, -0.03202, 0.00394],
    [0.11693, -0.21196, 0.02736, 0.25886],
])
_ZENITH_y = np.array([
    [0.00275, -0.00610, 0.00317, 0.0],
    [-0.04214, 0.08970, -0.04153, 0.00516],
    [0.15346, -0.26756, 0.06670, 0.26688],
])

# XYZ -> linear sRGB
_XYZ_TO_RGB = np.array([
    [3.2404542, -1.5371385, -0.4985314],
    [-0.9692660, 1.8760108, 0.0415560],
    [0.0556434, -0.2040259, 1.0572252],
])


def _perez(coef, cos_theta, gamma, cos_gamma):
    a, b, c, d, e = coef
    ct = np.maximum(cos_theta, 1e-3)
    return (1.0 + a * np.exp(b / ct)) * (
        1.0 + c * np.exp(d * gamma) + e * cos_gamma * cos_gamma
    )


def _zenith_luminance(turb, theta_s):
    chi = (4.0 / 9.0 - turb / 120.0) * (np.pi - 2.0 * theta_s)
    # kcd/m^2
    return ((4.0453 * turb - 4.9710) * np.tan(chi)
            - 0.2155 * turb + 2.4192)


def _sky_radiance(turb, theta, gamma, theta_s):
    """Spectral radiance (linear sRGB, relative units) of the sky in a
    direction at zenith angle theta with angle gamma to the sun."""
    tv = np.array([turb, 1.0])
    coef_Y = _PEREZ_Y @ tv
    coef_x = _PEREZ_x @ tv
    coef_y = _PEREZ_y @ tv

    t2 = np.array([turb * turb, turb, 1.0])
    ts = np.array([theta_s ** 3, theta_s ** 2, theta_s, 1.0])
    xz = float(t2 @ _ZENITH_x @ ts)
    yz = float(t2 @ _ZENITH_y @ ts)
    Yz = max(_zenith_luminance(turb, theta_s), 0.0) * 1000.0  # cd/m^2

    cos_t = np.cos(theta)
    cos_g = np.cos(gamma)
    cos_ts = np.cos(theta_s)

    def ratio(coef, zen):
        num = _perez(coef, cos_t, gamma, cos_g)
        den = _perez(coef, 1.0, theta_s, cos_ts)
        return zen * num / np.maximum(den, 1e-9)

    Y = ratio(coef_Y, Yz)
    x = ratio(coef_x, xz)
    y = ratio(coef_y, yz)

    y_safe = np.maximum(y, 1e-6)
    X = Y * x / y_safe
    Z = Y * (1.0 - x - y) / y_safe
    xyz = np.stack([X, Y, Z], axis=-1)
    rgb = xyz @ _XYZ_TO_RGB.T
    # photometric cd/m^2 -> radiometric-ish relative units (1/683 lm/W)
    return np.maximum(rgb, 0.0) / 683.0


def sun_radiance(turb, theta_s):
    """Approximate sun-disk RGB radiance: solar constant attenuated by a
    turbidity-dependent Beer term over the relative optical air mass,
    spread over the disk solid angle (ref behavior of sun.cpp at a much
    coarser spectral resolution)."""
    cos_ts = np.cos(theta_s)
    m = 1.0 / max(cos_ts + 0.15 * (93.885 - np.degrees(theta_s)) ** -1.253,
                  1e-3)  # Kasten-Young relative air mass
    # simple RGB extinction: stronger at the blue end, scaled by turbidity
    beta = 0.04608 * turb - 0.04586
    tau = np.exp(-m * (0.008735 * np.array([0.65, 0.55, 0.45]) ** -4.08
                       + beta * np.array([0.65, 0.55, 0.45]) ** -1.3))
    sun_sr = 2.0 * np.pi * (1.0 - np.cos(np.radians(SUN_APP_RADIUS_DEG)))
    e_sun = 1367.0  # W/m^2 solar constant
    return e_sun * tau / max(sun_sr, 1e-9) / 683.0


def sun_direction_from_time(year=2010, month=7, day=10, hour=15.0,
                            latitude=35.6894, longitude=139.6917,
                            timezone=9.0):
    """Sun direction (world, Y-up) from date/position — the same inputs the
    reference accepts (sunsky.cpp location/time properties).  Uses the
    standard solar-position algorithm (declination + hour angle)."""
    n = (np.datetime64(f"{year:04d}-{month:02d}-{day:02d}")
         - np.datetime64(f"{year:04d}-01-01")).astype(int) + 1
    decl = np.radians(23.45) * np.sin(2 * np.pi * (284 + n) / 365.0)
    solar_time = hour + (longitude / 15.0 - timezone)
    hour_angle = np.radians(15.0 * (solar_time - 12.0))
    lat = np.radians(latitude)
    sin_el = (np.sin(lat) * np.sin(decl)
              + np.cos(lat) * np.cos(decl) * np.cos(hour_angle))
    el = np.arcsin(np.clip(sin_el, -1.0, 1.0))
    az = np.arctan2(
        np.sin(hour_angle),
        np.cos(hour_angle) * np.sin(lat) - np.tan(decl) * np.cos(lat),
    )
    # world: Y up, X east, -Z north (matches the lat-long convention in
    # render/emitter.py env_uv_to_dir)
    return np.array([
        np.cos(el) * np.sin(az), np.sin(el), np.cos(el) * np.cos(az)
    ], np.float32)


def bake_sky(turbidity=3.0, sun_dir=None, height=128, with_sun=True,
             with_sky=True, sky_scale=1.0, sun_scale=1.0,
             ground_albedo=0.15):
    """Bake the Preetham sky (+ sun disk) into a lat-long RGB image
    (height, 2*height, 3) compatible with env_uv_to_dir (Y-up).

    Below the horizon the image holds ground_albedo times the mean sky
    radiance (the reference's ground plane behavior at its simplest)."""
    if sun_dir is None:
        sun_dir = sun_direction_from_time()
    sun_dir = np.asarray(sun_dir, np.float32)
    sun_dir = sun_dir / max(np.linalg.norm(sun_dir), 1e-9)
    theta_s = float(np.arccos(np.clip(sun_dir[1], -1.0, 1.0)))
    theta_s = min(theta_s, np.radians(89.0))

    H, W = height, 2 * height
    v = (np.arange(H) + 0.5) / H
    uu = (np.arange(W) + 0.5) / W
    theta = v * np.pi                       # angle from +Y
    phi = uu * 2.0 * np.pi - np.pi
    st, ct = np.sin(theta), np.cos(theta)
    dirs = np.stack([
        np.outer(st, np.sin(phi)),
        np.outer(ct, np.ones_like(phi)),
        np.outer(st, np.cos(phi)),
    ], axis=-1)  # (H, W, 3)

    cos_g = np.clip(dirs @ sun_dir, -1.0, 1.0)
    gamma = np.arccos(cos_g)
    img = np.zeros((H, W, 3), np.float32)
    above = dirs[..., 1] > 0.0
    if with_sky:
        sky = _sky_radiance(
            turbidity, np.arccos(np.clip(dirs[..., 1], -1.0, 1.0)),
            gamma, theta_s,
        ) * sky_scale
        img = np.where(above[..., None], sky, 0.0).astype(np.float32)
        mean_sky = img[above].mean(axis=0) if above.any() else 0.0
        img[~above] = ground_albedo * mean_sky
    if with_sun and sun_dir[1] > 0.0:
        l_sun = (sun_radiance(turbidity, theta_s)
                 * sun_scale).astype(np.float32)
        disk = gamma < np.radians(SUN_APP_RADIUS_DEG)
        if disk.any():
            img[disk] += l_sun
        else:
            # disk smaller than a texel: deposit the disk's total power in
            # the containing texel so the baked image conserves energy
            sun_sr = 2.0 * np.pi * (
                1.0 - np.cos(np.radians(SUN_APP_RADIUS_DEG)))
            row = int(np.clip(theta_s / np.pi * H, 0, H - 1))
            phi_s = np.arctan2(sun_dir[0], sun_dir[2])
            col = int(np.clip((phi_s + np.pi) / (2 * np.pi) * W, 0, W - 1))
            texel_sr = (np.pi / H) * (2 * np.pi / W) * max(
                np.sin(theta_s), 1e-3)
            img[row, col] += l_sun * sun_sr / texel_sr
    return img
