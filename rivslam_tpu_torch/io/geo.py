"""WGS-84 geodetic -> UTM conversion (host-side, numpy): a copy of
``rivslam_tpu/io/geo.py``, which has no jax in it.

Replaces the reference's geodesy::fromMsg(GeoPoint, UTMPoint) dependency
(src/gps_traj_align.cpp:160-170, radar_graph_slam_nodelet.cpp:27): NavSatFix
latitude/longitude/altitude -> (easting, northing, altitude) in the point's
UTM zone. Implementation is the standard transverse-Mercator Krüger series
(6th order in n), good to well under a millimetre — far below GPS noise.

Pure numpy, vectorized over arrays of fixes.
"""

from __future__ import annotations

import numpy as np

# WGS-84
_A = 6378137.0  # semi-major axis [m]
_F = 1.0 / 298.257223563  # flattening
_K0 = 0.9996  # UTM scale factor
_E0 = 500000.0  # false easting
_N0_SOUTH = 10000000.0  # false northing (southern hemisphere)


def utm_zone(lat_deg, lon_deg) -> np.ndarray:
    """UTM zone number (1..60). Includes the Norway/Svalbard exceptions the
    standard grid defines (geodesy's UTMPoint applies the same rules)."""
    lat = np.asarray(lat_deg, dtype=np.float64)
    lon = np.asarray(lon_deg, dtype=np.float64)
    zone = (np.floor((lon + 180.0) / 6.0).astype(np.int64) % 60) + 1
    # Norway: 56..64N, 3..12E -> zone 32
    zone = np.where((lat >= 56.0) & (lat < 64.0) & (lon >= 3.0) & (lon < 12.0), 32, zone)
    # Svalbard: 72..84N
    sval = (lat >= 72.0) & (lat < 84.0)
    zone = np.where(sval & (lon >= 0.0) & (lon < 9.0), 31, zone)
    zone = np.where(sval & (lon >= 9.0) & (lon < 21.0), 33, zone)
    zone = np.where(sval & (lon >= 21.0) & (lon < 33.0), 35, zone)
    zone = np.where(sval & (lon >= 33.0) & (lon < 42.0), 37, zone)
    return zone


def latlon_to_utm(
    lat_deg, lon_deg, zone: int | None = None
) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(easting, northing, zone) for WGS-84 lat/lon in degrees.

    `zone` pins the computation to a fixed zone (all fixes of one trajectory
    must share a zone so coordinates are mutually consistent, even if the
    path crosses a zone boundary). Default: zone of the first fix.
    """
    lat = np.atleast_1d(np.asarray(lat_deg, dtype=np.float64))
    lon = np.atleast_1d(np.asarray(lon_deg, dtype=np.float64))
    zones = utm_zone(lat, lon)
    if zone is None:
        zone = int(np.atleast_1d(zones)[0])
    lon0 = np.radians(zone * 6.0 - 183.0)  # central meridian
    phi = np.radians(lat)
    lam = np.radians(lon) - lon0

    # Krüger series (UTM per Karney 2011 "Transverse Mercator with an
    # accuracy of a few nanometers", truncated to alpha_1..alpha_6)
    n = _F / (2.0 - _F)
    n2, n3, n4, n5, n6 = n**2, n**3, n**4, n**5, n**6
    # conformal latitude
    e = np.sqrt(_F * (2.0 - _F))
    t = np.sinh(
        np.arctanh(np.sin(phi)) - e * np.arctanh(e * np.sin(phi))
    )
    xi_p = np.arctan2(t, np.cos(lam))
    eta_p = np.arcsinh(np.sin(lam) / np.hypot(t, np.cos(lam)))

    A = _A / (1.0 + n) * (1.0 + n2 / 4.0 + n4 / 64.0 + n6 / 256.0)
    alpha = np.array([
        n / 2.0 - 2.0 / 3.0 * n2 + 5.0 / 16.0 * n3 + 41.0 / 180.0 * n4
        - 127.0 / 288.0 * n5 + 7891.0 / 37800.0 * n6,
        13.0 / 48.0 * n2 - 3.0 / 5.0 * n3 + 557.0 / 1440.0 * n4
        + 281.0 / 630.0 * n5 - 1983433.0 / 1935360.0 * n6,
        61.0 / 240.0 * n3 - 103.0 / 140.0 * n4 + 15061.0 / 26880.0 * n5
        + 167603.0 / 181440.0 * n6,
        49561.0 / 161280.0 * n4 - 179.0 / 168.0 * n5 + 6601661.0 / 7257600.0 * n6,
        34729.0 / 80640.0 * n5 - 3418889.0 / 1995840.0 * n6,
        212378941.0 / 319334400.0 * n6,
    ])
    xi = xi_p.copy()
    eta = eta_p.copy()
    for j in range(6):
        k = 2 * (j + 1)
        xi = xi + alpha[j] * np.sin(k * xi_p) * np.cosh(k * eta_p)
        eta = eta + alpha[j] * np.cos(k * xi_p) * np.sinh(k * eta_p)

    easting = _E0 + _K0 * A * eta
    northing = _K0 * A * xi
    northing = np.where(lat < 0.0, northing + _N0_SOUTH, northing)
    zone_arr = np.full_like(easting, float(zone))
    if np.isscalar(lat_deg) or np.ndim(lat_deg) == 0:
        return float(easting[0]), float(northing[0]), int(zone)
    return easting, northing, zone_arr


def navsat_to_utm(
    lat_deg, lon_deg, alt_m, zone: int | None = None
) -> np.ndarray:
    """[..., 3] (easting, northing, altitude) — the reference's UTM triple
    (gps_traj_align.cpp:168-170: Vector3d(utm.easting, utm.northing,
    utm.altitude))."""
    e, nn, _ = latlon_to_utm(lat_deg, lon_deg, zone=zone)
    return np.stack(
        [np.atleast_1d(np.asarray(e, np.float64)),
         np.atleast_1d(np.asarray(nn, np.float64)),
         np.atleast_1d(np.asarray(alt_m, np.float64))], axis=-1
    ).squeeze()
