"""Stellar engine: sun/earth positions over a lunar surface site.

A copy of the JAX package's ``aux/stellar.py``, which uses numpy and scipy
only; the port keeps its own so that it imports nothing of the JAX package.

Re-derivation of ``src/stellar/stellar_engine.py:17-297``. The reference
computes alt-az of the Sun/Earth from a lunar lat/lon observer with skyfield
(de421 + lunar frames); skyfield and its ephemeris files are not in this
image, so this engine uses self-contained analytic ephemerides:

* geocentric lunar position from the Meeus ch. 47 ELP-derived series
  (~60 longitude/latitude/distance terms with the eccentricity E factor
  and the A1/A2/A3 additive terms) — position error ~0.01 deg / ~1 km;
* Sun from the standard solar-longitude series (ch. 25, ~0.01 deg), seen
  from the Moon via exact vector subtraction of the lunar position;
* the lunar-fixed (selenographic, mean-Earth) frame is built from the
  optical-libration construction (Meeus ch. 53: inclination I = 1.54242
  deg, node Omega, prime meridian at angle F from the node) — the up-to-8
  deg optical librations the previous synchronous approximation ignored
  are now in the frame. Omitted: physical librations (~0.04 deg),
  nutation (~0.005 deg), TD-UTC (~0.01 deg) — total site-frame error well
  under 0.1 deg, verified against the Meeus worked example (47.a / 53.a)
  and syzygy alignment epochs in the JAX package's tests.

API mirrors the reference: ``set_lat_lon``, ``set_time``, ``set_time_scale``,
``update(dt)`` with update-interval gating, ``get_alt_az``,
``get_local_position``, ``convert_alt_az_to_quat``.
"""

from __future__ import annotations

import dataclasses
import datetime
import math

import numpy as np
from scipy.spatial.transform import Rotation

AU_M = 1.495978707e11
MOON_DIST_M = 3.844e8


@dataclasses.dataclass
class Date:
    """src/configurations/stellar_engine_confs.py Date."""

    year: int = 2024
    month: int = 5
    day: int = 1
    hour: int = 12
    minute: int = 0


@dataclasses.dataclass
class StellarEngineConf:
    start_date: Date = dataclasses.field(default_factory=Date)
    time_scale: float = 1.0
    update_interval: float = 600.0
    lat: float = -26.0
    lon: float = 46.8


def _julian_day(dt: datetime.datetime) -> float:
    y, m = dt.year, dt.month
    d = (
        dt.day
        + dt.hour / 24.0
        + dt.minute / 1440.0
        + dt.second / 86400.0
    )
    if m <= 2:
        y -= 1
        m += 12
    a = y // 100
    b = 2 - a + a // 4
    return int(365.25 * (y + 4716)) + int(30.6001 * (m + 1)) + d + b - 1524.5


def _sun_ecliptic(jd: float):
    """Low-precision solar ecliptic longitude (rad) and distance (AU)."""
    t = (jd - 2451545.0) / 36525.0
    l0 = math.radians((280.46646 + 36000.76983 * t) % 360.0)
    m = math.radians((357.52911 + 35999.05029 * t) % 360.0)
    c = math.radians(
        (1.914602 - 0.004817 * t) * math.sin(m)
        + (0.019993 - 0.000101 * t) * math.sin(2 * m)
        + 0.000289 * math.sin(3 * m)
    )
    lon = l0 + c
    e = 0.016708634 - 0.000042037 * t
    nu = m + c
    dist = 1.000001018 * (1 - e * e) / (1 + e * math.cos(nu))
    return lon, dist


# Meeus ch. 47 periodic terms: (D, M, M', F, coeff). Longitude/distance
# table 47.A (coeff in 1e-6 deg / 1e-3 km), latitude table 47.B (1e-6 deg).
_LON_TERMS = (
    (0, 0, 1, 0, 6288774), (2, 0, -1, 0, 1274027), (2, 0, 0, 0, 658314),
    (0, 0, 2, 0, 213618), (0, 1, 0, 0, -185116), (0, 0, 0, 2, -114332),
    (2, 0, -2, 0, 58793), (2, -1, -1, 0, 57066), (2, 0, 1, 0, 53322),
    (2, -1, 0, 0, 45758), (0, 1, -1, 0, -40923), (1, 0, 0, 0, -34720),
    (0, 1, 1, 0, -30383), (2, 0, 0, -2, 15327), (0, 0, 1, 2, -12528),
    (0, 0, 1, -2, 10980), (4, 0, -1, 0, 10675), (0, 0, 3, 0, 10034),
    (4, 0, -2, 0, 8548), (2, 1, -1, 0, -7888), (2, 1, 0, 0, -6766),
    (1, 0, -1, 0, -5163), (1, 1, 0, 0, 4987), (2, -1, 1, 0, 4036),
    (2, 0, 2, 0, 3994), (4, 0, 0, 0, 3861), (2, 0, -3, 0, 3665),
    (0, 1, -2, 0, -2689), (2, 0, -1, 2, -2602), (2, -1, -2, 0, 2390),
    (1, 0, 1, 0, -2348), (2, -2, 0, 0, 2236), (0, 1, 2, 0, -2120),
    (0, 2, 0, 0, -2069), (2, -2, -1, 0, 2048), (2, 0, 1, -2, -1773),
    (2, 0, 0, 2, -1595), (4, -1, -1, 0, 1215), (0, 0, 2, 2, -1110),
    (3, 0, -1, 0, -892), (2, 1, 1, 0, -810), (4, -1, -2, 0, 759),
    (0, 2, -1, 0, -713), (2, 2, -1, 0, -700), (2, 1, -2, 0, 691),
    (2, -1, 0, -2, 596), (4, 0, 1, 0, 549), (0, 0, 4, 0, 537),
    (4, -1, 0, 0, 520), (1, 0, -2, 0, -487), (2, 1, 0, -2, -399),
    (0, 0, 2, -2, -381), (1, 1, 1, 0, 351), (3, 0, -2, 0, -340),
    (4, 0, -3, 0, 330), (2, -1, 2, 0, 327), (0, 2, 1, 0, -323),
    (1, 1, -1, 0, 299), (2, 0, 3, 0, 294),
)
_DIST_TERMS = (
    (0, 0, 1, 0, -20905355), (2, 0, -1, 0, -3699111),
    (2, 0, 0, 0, -2955968), (0, 0, 2, 0, -569925), (0, 1, 0, 0, 48888),
    (0, 0, 0, 2, -3149), (2, 0, -2, 0, 246158), (2, -1, -1, 0, -152138),
    (2, 0, 1, 0, -170733), (2, -1, 0, 0, -204586), (0, 1, -1, 0, -129620),
    (1, 0, 0, 0, 108743), (0, 1, 1, 0, 104755), (2, 0, 0, -2, 10321),
    (0, 0, 1, -2, 79661), (4, 0, -1, 0, -34782), (0, 0, 3, 0, -23210),
    (4, 0, -2, 0, -21636), (2, 1, -1, 0, 24208), (2, 1, 0, 0, 30824),
    (1, 0, -1, 0, -8379), (1, 1, 0, 0, -16675), (2, -1, 1, 0, -12831),
    (2, 0, 2, 0, -10445), (4, 0, 0, 0, -11650), (2, 0, -3, 0, 14403),
    (0, 1, -2, 0, -7003), (2, -1, -2, 0, 10056), (1, 0, 1, 0, 6322),
    (2, -2, 0, 0, -9884), (0, 1, 2, 0, 5751), (2, -2, -1, 0, -4950),
    (2, 0, 1, -2, 4130), (4, -1, -1, 0, -3958), (3, 0, -1, 0, 3258),
    (2, 1, 1, 0, 2616), (4, -1, -2, 0, -1897), (0, 2, -1, 0, -2117),
    (2, 2, -1, 0, 2354), (4, 0, 1, 0, -1423), (0, 0, 4, 0, -1117),
    (4, -1, 0, 0, -1571), (1, 0, -2, 0, -1739), (0, 0, 2, -2, -4421),
    (0, 2, 1, 0, 1165), (2, 0, -1, -2, 8752),
)
_LAT_TERMS = (
    (0, 0, 0, 1, 5128122), (0, 0, 1, 1, 280602), (0, 0, 1, -1, 277693),
    (2, 0, 0, -1, 173237), (2, 0, -1, 1, 55413), (2, 0, -1, -1, 46271),
    (2, 0, 0, 1, 32573), (0, 0, 2, 1, 17198), (2, 0, 1, -1, 9266),
    (0, 0, 2, -1, 8822), (2, -1, 0, -1, 8216), (2, 0, -2, -1, 4324),
    (2, 0, 1, 1, 4200), (2, 1, 0, -1, -3359), (2, -1, -1, 1, 2463),
    (2, -1, 0, 1, 2211), (2, -1, -1, -1, 2065), (0, 1, -1, -1, -1870),
    (4, 0, -1, -1, 1828), (0, 1, 0, 1, -1794), (0, 0, 0, 3, -1749),
    (0, 1, -1, 1, -1565), (1, 0, 0, 1, -1491), (0, 1, 1, 1, -1475),
    (0, 1, 1, -1, -1410), (0, 1, 0, -1, -1344), (1, 0, 0, -1, -1335),
    (0, 0, 3, 1, 1107), (4, 0, 0, -1, 1021), (4, 0, -1, 1, 833),
    (0, 0, 1, -3, 777), (4, 0, -2, 1, 671), (2, 0, 0, -3, 607),
    (2, 0, 2, -1, 596), (2, -1, 1, -1, 491), (2, 0, -2, 1, -451),
    (0, 0, 3, -1, 439), (2, 0, 2, 1, 422), (2, 0, -3, -1, 421),
)


def _moon_elements(jd: float):
    """Mean elements (Meeus 47.1-47.5), degrees."""
    t = (jd - 2451545.0) / 36525.0
    lp = (218.3164477 + 481267.88123421 * t - 0.0015786 * t * t
          + t**3 / 538841.0 - t**4 / 65194000.0)
    d = (297.8501921 + 445267.1114034 * t - 0.0018819 * t * t
         + t**3 / 545868.0 - t**4 / 113065000.0)
    m = (357.5291092 + 35999.0502909 * t - 0.0001536 * t * t
         + t**3 / 24490000.0)
    mp = (134.9633964 + 477198.8675055 * t + 0.0087414 * t * t
          + t**3 / 69699.0 - t**4 / 14712000.0)
    f = (93.2720950 + 483202.0175233 * t - 0.0036539 * t * t
         - t**3 / 3526000.0 + t**4 / 863310000.0)
    return t, lp, d, m, mp, f


def _moon_ecliptic(jd: float):
    """Geocentric lunar ecliptic lon/lat (rad) and distance (m) — Meeus
    ch. 47 full periodic-term tables with the E eccentricity factor and
    the A1/A2/A3 additive terms (example 47.a parity in tests)."""
    t, lp, d, m, mp, f = _moon_elements(jd)
    a1 = math.radians((119.75 + 131.849 * t) % 360.0)
    a2 = math.radians((53.09 + 479264.290 * t) % 360.0)
    a3 = math.radians((313.45 + 481266.484 * t) % 360.0)
    e = 1.0 - 0.002516 * t - 0.0000074 * t * t
    rd, rm, rmp, rf = (math.radians(x % 360.0) for x in (d, m, mp, f))
    lp_r = math.radians(lp % 360.0)

    sl = 0.0
    for cd, cm, cmp_, cf, coeff in _LON_TERMS:
        amp = coeff * (e ** abs(cm))
        sl += amp * math.sin(cd * rd + cm * rm + cmp_ * rmp + cf * rf)
    sl += 3958 * math.sin(a1) + 1962 * math.sin(lp_r - rf) + 318 * math.sin(a2)

    sb = 0.0
    for cd, cm, cmp_, cf, coeff in _LAT_TERMS:
        amp = coeff * (e ** abs(cm))
        sb += amp * math.sin(cd * rd + cm * rm + cmp_ * rmp + cf * rf)
    sb += (-2235 * math.sin(lp_r) + 382 * math.sin(a3)
           + 175 * math.sin(a1 - rf) + 175 * math.sin(a1 + rf)
           + 127 * math.sin(lp_r - rmp) - 115 * math.sin(lp_r + rmp))

    sr = 0.0
    for cd, cm, cmp_, cf, coeff in _DIST_TERMS:
        amp = coeff * (e ** abs(cm))
        sr += amp * math.cos(cd * rd + cm * rm + cmp_ * rmp + cf * rf)

    lon = lp_r + math.radians(sl * 1e-6)
    lat = math.radians(sb * 1e-6)
    dist = (385000.56 + sr * 1e-3) * 1e3
    return lon, lat, dist


_MOON_EQ_INCL = math.radians(1.54242)  # mean lunar equator vs ecliptic


def _moon_frame(jd: float):
    """Lunar-fixed (mean-Earth selenographic) basis in ecliptic coords —
    the optical-libration frame of Meeus ch. 53: pole inclined I to the
    ecliptic at node Omega, prime meridian at angle F from the node.
    Returns rows (x_sel, y_sel, z_sel)."""
    t = (jd - 2451545.0) / 36525.0
    omega = math.radians((125.0445479 - 1934.1362891 * t + 0.0020754 * t * t
                          + t**3 / 467441.0 - t**4 / 60616000.0) % 360.0)
    _, _, _, _, _, f = _moon_elements(jd)
    f = math.radians(f % 360.0)
    si, ci = math.sin(_MOON_EQ_INCL), math.cos(_MOON_EQ_INCL)
    # pole/prime-meridian signs derived from the Meeus 53.1 libration
    # formulas (so that the Earth direction lands at (l', b') exactly —
    # cross-checked numerically in tests): the prime meridian sits at
    # angle F + 180 deg from the ascending node along the lunar equator
    # (the node-frame azimuth of the Earth is A + 180, l' = A - F).
    pole = np.array([-si * math.sin(omega), si * math.cos(omega), ci])
    node = np.array([math.cos(omega), math.sin(omega), 0.0])
    x_sel = -(node * math.cos(f) + np.cross(pole, node) * math.sin(f))
    y_sel = np.cross(pole, x_sel)
    return np.stack([x_sel, y_sel, pole])


def _ecl_to_vec(lon, lat):
    return np.array([
        math.cos(lat) * math.cos(lon),
        math.cos(lat) * math.sin(lon),
        math.sin(lat),
    ])


class StellarEngine:
    """Sun/Earth alt-az over a lunar site (stellar_engine.py API)."""

    def __init__(self, cfg: StellarEngineConf):
        self.cfg = cfg
        d = cfg.start_date
        self.current_time = datetime.datetime(
            d.year, d.month, d.day, d.hour, d.minute,
            tzinfo=datetime.timezone.utc,
        )
        self.last_update = self.current_time
        self.set_lat_lon(cfg.lat, cfg.lon)

    def set_lat_lon(self, lat: float, lon: float) -> None:
        self.lat = math.radians(lat)
        self.lon = math.radians(lon)

    def set_time(self, date: datetime.datetime) -> None:
        self.current_time = date
        self.last_update = date

    def set_time_scale(self, time_scale: float) -> None:
        self.cfg.time_scale = time_scale

    def update(self, dt: float) -> bool:
        """Advance scaled time; recompute only every ``update_interval``
        (stellar_engine.py:154-175)."""
        self.current_time += datetime.timedelta(
            seconds=dt * self.cfg.time_scale
        )
        delta = (self.current_time - self.last_update).total_seconds()
        if delta >= self.cfg.update_interval:
            self.last_update = self.current_time
            return True
        return False

    # --- geometry ----------------------------------------------------------
    def _body_direction_selenographic(self, body: str):
        """Unit direction + distance of a body in the mean-Earth
        selenographic frame (x toward mean Earth, z lunar north ~ ecliptic
        north under the synchronous approximation)."""
        jd = _julian_day(self.current_time)
        m_lon, m_lat, m_dist = _moon_ecliptic(jd)
        earth_dir_ecl = -_ecl_to_vec(m_lon, m_lat)  # Earth as seen from Moon
        if body == "earth":
            target_ecl, dist = earth_dir_ecl, m_dist
        elif body == "sun":
            s_lon, s_dist = _sun_ecliptic(jd)
            # Sun from Moon = Sun from Earth - Moon from Earth
            sun_vec = _ecl_to_vec(s_lon, 0.0) * s_dist * AU_M
            moon_vec = _ecl_to_vec(m_lon, m_lat) * m_dist
            rel = sun_vec - moon_vec
            dist = float(np.linalg.norm(rel))
            target_ecl = rel / dist
        else:
            raise ValueError(f"unknown body {body!r}")

        # lunar-fixed frame from the optical-libration construction
        # (Meeus ch. 53) — the Earth sits near (0, 0) but wanders by the
        # +/-8 deg librations, exactly as over a real lunar site
        rot = _moon_frame(jd)  # ecliptic -> selenographic
        return rot @ target_ecl, dist

    def get_alt_az(self, body: str):
        """(alt deg, az deg, distance m) of a body over the site
        (stellar_engine.py:91-104)."""
        d_sel, dist = self._body_direction_selenographic(body)
        # site basis: up from lat/lon, north toward +z_sel, east completes
        clat, slat = math.cos(self.lat), math.sin(self.lat)
        clon, slon = math.cos(self.lon), math.sin(self.lon)
        up = np.array([clat * clon, clat * slon, slat])
        north = np.array([-slat * clon, -slat * slon, clat])
        east = np.cross(north, up)
        alt = math.degrees(math.asin(np.clip(np.dot(d_sel, up), -1, 1)))
        az = math.degrees(
            math.atan2(np.dot(d_sel, east), np.dot(d_sel, north))
        ) % 360.0
        return alt, az, dist

    def get_local_position(self, body: str):
        """Cartesian site-frame position (stellar_engine.py:135-152)."""
        alt, az, dist = self.get_alt_az(body)
        return (
            dist * math.cos(math.radians(alt)) * math.cos(math.radians(az)),
            dist * math.cos(math.radians(alt)) * math.sin(math.radians(az)),
            dist * math.sin(math.radians(alt)),
        )

    @staticmethod
    def convert_alt_az_to_quat(alt: float, az: float):
        """Quaternion (w, x, y, z) rotating a [0, 0, -1] light to the alt/az
        (stellar_engine.py:177-193)."""
        x, y, z, w = Rotation.from_euler(
            "xyz", [0, alt, az - 90], degrees=True
        ).as_quat()
        return (w, x, y, z)
