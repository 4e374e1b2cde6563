"""FITS images and binary tables with numpy alone (maria_tpu/io/fits.py).

The subset the package needs: primary image HDUs with a tangent-plane
WCS for maps, and binary tables for TODs (the MUSTANG-2 format). Cards
are 80 bytes, blocks 2,880, data big-endian.
"""

from __future__ import annotations

import numpy as np

__all__ = ["FITS_DEFAULT_UNITS", "FITS_FRAMES", "FITS_KWARG_ALIASES", "FITS_TYPE_ALIASES", "parse_fits_map_header",
           "read_fits", "read_fits_map", "write_fits", "write_fits_bintable", "write_fits_map"]

BLOCK = 2880

_BITPIX_DTYPES = {
    8: np.dtype(">u1"),
    16: np.dtype(">i2"),
    32: np.dtype(">i4"),
    64: np.dtype(">i8"),
    -32: np.dtype(">f4"),
    -64: np.dtype(">f8"),
}

# binary-table column formats: FITS TFORM letter -> numpy big-endian dtype
_TFORM_DTYPES = {"L": ">u1", "B": ">u1", "I": ">i2", "J": ">i4", "K": ">i8", "E": ">f4", "D": ">f8"}


def _format_card(key: str, value, comment: str = "") -> bytes:
    if isinstance(value, bool):
        card = f"{key:<8}= {'T' if value else 'F':>20}"
    elif isinstance(value, (int, np.integer)):
        card = f"{key:<8}= {value:>20}"
    elif isinstance(value, (float, np.floating)):
        card = f"{key:<8}= {value:>20.13E}"
    elif value is None:
        card = f"{key:<8}"
    else:
        card = f"{key:<8}= '{str(value):<8}'"
    if comment:
        card += f" / {comment}"
    return card[:80].ljust(80).encode("ascii")


def _parse_header(block_bytes: bytes) -> dict:
    header = {}
    for i in range(0, len(block_bytes), 80):
        card = block_bytes[i:i + 80].decode("ascii", errors="replace")
        key = card[:8].strip()
        if key == "END":
            break
        if "=" not in card[8:10]:
            continue
        raw = card[10:].split("/")[0].strip()
        if raw.startswith("'"):
            value = raw.strip("'").strip()
        elif raw in ("T", "F"):
            value = raw == "T"
        else:
            try:
                value = int(raw)
            except ValueError:
                try:
                    value = float(raw)
                except ValueError:
                    value = raw
        header[key] = value
    return header


def _bintable_dtype(header) -> np.dtype:
    fields = []
    for i in range(1, header["TFIELDS"] + 1):
        name = str(header.get(f"TTYPE{i}", f"col{i}")).strip()
        tform = str(header[f"TFORM{i}"]).strip()
        count = int(tform[:-1]) if tform[:-1] else 1  # a repeat count prefix: '1E', 'E', '3D'
        dt = _TFORM_DTYPES[tform[-1]]
        fields.append((name, dt, (count,)) if count > 1 else (name, dt))
    return np.dtype(fields)


def _padded(payload: bytes, fill: bytes) -> bytes:
    return payload + fill * (-len(payload) % BLOCK)


def read_fits(path: str) -> list:
    """Every HDU of the file as (header, data or None): image HDUs give
    arrays (scaled by BSCALE and BZERO), BINTABLE HDUs structured arrays.
    A file cut short ends the list at its last whole HDU."""
    hdus = []
    with open(path, "rb") as f:
        raw = f.read()
    pos = 0
    while pos < len(raw):
        header_bytes = b""
        while True:
            block = raw[pos:pos + BLOCK]
            if len(block) < BLOCK:
                return hdus
            header_bytes += block
            pos += BLOCK
            if any(block[i:i + 8].rstrip() == b"END" for i in range(0, BLOCK, 80)):
                break
        header = _parse_header(header_bytes)
        data = None
        if str(header.get("XTENSION", "")).startswith("BINTABLE"):
            dtype = _bintable_dtype(header)
            n_bytes = dtype.itemsize * header["NAXIS2"]
            if pos + n_bytes > len(raw):
                return hdus
            data = np.frombuffer(raw[pos:pos + n_bytes], dtype=dtype)
            pos += -(-n_bytes // BLOCK) * BLOCK
        elif header.get("NAXIS", 0) and header.get("BITPIX") in _BITPIX_DTYPES:
            shape = [header[f"NAXIS{i}"] for i in range(header["NAXIS"], 0, -1)]
            dtype = _BITPIX_DTYPES[header["BITPIX"]]
            n_bytes = int(np.prod(shape)) * dtype.itemsize
            if pos + n_bytes > len(raw):
                return hdus
            data = np.frombuffer(raw[pos:pos + n_bytes], dtype=dtype).reshape(shape)
            data = data * header.get("BSCALE", 1.0) + header.get("BZERO", 0.0)
            pos += -(-n_bytes // BLOCK) * BLOCK
        hdus.append((header, data))
    return hdus


def write_fits_bintable(path: str, columns: list, header_cards: list = ()):
    """An empty primary HDU and one binary table. ``columns`` is a list of
    (name, TFORM letter, array or None, unit); the arrays share a length
    and a None column is zeros. ``header_cards`` are (key, value[,
    comment]) of the table's header."""
    n_rows = max(len(a) for _, _, a, _ in columns if a is not None)
    fields, arrays = [], []
    for name, letter, arr, _ in columns:
        dt = _TFORM_DTYPES[letter]
        arrays.append(np.zeros(n_rows, dtype=dt) if arr is None else np.asarray(arr).astype(dt))
        fields.append((name.strip(), dt))
    rec = np.empty(n_rows, dtype=np.dtype(fields))
    for (name, _), arr in zip(fields, arrays):
        rec[name] = arr

    primary = [_format_card("SIMPLE", True), _format_card("BITPIX", 8), _format_card("NAXIS", 0),
               _format_card("EXTEND", True), "END".ljust(80).encode("ascii")]
    cards = [
        _format_card("XTENSION", "BINTABLE"), _format_card("BITPIX", 8), _format_card("NAXIS", 2),
        _format_card("NAXIS1", rec.dtype.itemsize), _format_card("NAXIS2", n_rows), _format_card("PCOUNT", 0),
        _format_card("GCOUNT", 1), _format_card("TFIELDS", len(columns)),
    ]
    for i, (name, letter, _, unit) in enumerate(columns, start=1):
        cards.append(_format_card(f"TTYPE{i}", name))
        cards.append(_format_card(f"TFORM{i}", letter))
        if unit:
            cards.append(_format_card(f"TUNIT{i}", unit))
    for key, value, *comment in header_cards:
        cards.append(_format_card(key, value, comment[0] if comment else ""))
    cards.append("END".ljust(80).encode("ascii"))
    with open(path, "wb") as f:
        f.write(_padded(b"".join(primary), b" "))
        f.write(_padded(b"".join(cards), b" "))
        f.write(_padded(rec.tobytes(), b"\x00"))


def write_fits(path: str, header_cards: list, data: np.ndarray = None):
    """One image HDU of ``data`` (float32, float64, int32 or int16) with
    the cards (key, value[, comment])."""
    cards = [_format_card("SIMPLE", True, "conforms to FITS standard")]
    if data is not None:
        data = np.ascontiguousarray(data)
        bitpix = {np.float32: -32, np.float64: -64, np.int32: 32, np.int16: 16}[data.dtype.type]
        cards.append(_format_card("BITPIX", bitpix))
        cards.append(_format_card("NAXIS", data.ndim))
        for i, n in enumerate(reversed(data.shape)):
            cards.append(_format_card(f"NAXIS{i + 1}", n))
    else:
        cards.append(_format_card("BITPIX", 8))
        cards.append(_format_card("NAXIS", 0))
    for key, value, *comment in header_cards:
        cards.append(_format_card(key, value, comment[0] if comment else ""))
    cards.append("END".ljust(80).encode("ascii"))
    with open(path, "wb") as f:
        f.write(_padded(b"".join(cards), b" "))
        if data is not None:
            f.write(_padded(data.astype(data.dtype.newbyteorder(">")).tobytes(), b"\x00"))


def write_fits_map(m, path: str):
    """A ProjectionMap's data as one float32 image with a SIN WCS, x
    stored flipped (RA grows leftward: CDELT1 < 0), as maria_tpu writes
    it. Beyond maria_tpu's cards, a map of several channels carries every
    channel's frequency (NU1, NU2, ...) and its Stokes letters (STOKES),
    which maria_tpu's reader ignores."""
    cards = [
        ("CTYPE1", "RA---SIN" if m.frame == "ra/dec" else "AZ---SIN"),
        ("CTYPE2", "DEC--SIN" if m.frame == "ra/dec" else "EL---SIN"),
        ("CRVAL1", float(np.degrees(m.center[0]))),
        ("CRVAL2", float(np.degrees(m.center[1]))),
        ("CDELT1", -float(np.degrees(m.x_res))),
        ("CDELT2", float(np.degrees(m.y_res))),
        ("CRPIX1", (m.n_x + 1) / 2),
        ("CRPIX2", (m.n_y + 1) / 2),
        ("BUNIT", m.units),
        ("RESTFRQ", float(m.nu[0])),
        ("STOKES", m.stokes),
    ]
    if m.n_nu > 1:
        cards += [(f"NU{i + 1}", float(nu)) for i, nu in enumerate(m.nu)]
    write_fits(path, cards, m.data.detach().cpu().numpy().astype(np.float32)[..., ::-1])


def parse_fits_map_header(header: dict) -> dict:
    """The map's construction keywords a FITS image header implies:
    resolution and center (degrees), frequency, units, frame, and whether
    the x axis must be flipped to run along ascending tangent-plane dx."""
    n_nu = sum(1 for key in header if key[:2] == "NU" and key[2:].isdigit())
    nu = [header[f"NU{i + 1}"] for i in range(n_nu)] if n_nu else header.get("RESTFRQ", 150e9)
    return {
        "resolution": abs(header.get("CDELT1", header.get("CD1_1", np.nan))),
        "center": (header.get("CRVAL1", 0.0), header.get("CRVAL2", 0.0)),
        "nu": nu,
        "units": header.get("BUNIT", "K_RJ"),
        "frame": "ra/dec" if str(header.get("CTYPE1", "RA")).startswith("RA") else "az/el",
        "flip_x": header.get("CDELT1", -1) < 0,
        "stokes": header.get("STOKES"),
    }


def read_fits_map(path: str, index: int = 0, **kwargs):
    """The ``index``-th image of a FITS file as a ProjectionMap on the
    host; keywords given (width, nu, units, center, ...) override what the
    header implies, and width or height replaces its resolution."""
    from ..map.projection import ProjectionMap

    hdus = [h for h in read_fits(path) if h[1] is not None]
    if not hdus:
        raise ValueError(f"No image data in '{path}'.")
    header, data = hdus[index]
    parsed = parse_fits_map_header(header)
    data = np.asarray(data, dtype=np.float32)
    if parsed["flip_x"]:
        data = data[..., ::-1]
    kw = dict(data=np.ascontiguousarray(data), center=parsed["center"], resolution=parsed["resolution"],
              frame=parsed["frame"], nu=np.atleast_1d(parsed["nu"]), units=parsed["units"], degrees=True)
    if parsed["stokes"]:
        kw["stokes"] = parsed["stokes"]
    if "width" in kwargs or "height" in kwargs:
        kw.pop("resolution")
    if "nu" in kwargs:
        kwargs["nu"] = np.atleast_1d(kwargs["nu"])
    kw.update(kwargs)
    return ProjectionMap(**kw)


# FITS axis and keyword classification tables, for users who classify
# their own headers (maria_tpu/io/fits.py)
FITS_TYPE_ALIASES = {
    "stokes": ["STOKES"],
    "nu": ["NU", "FREQ"],
    "v": ["VRAD", "VELO"],
    "t": ["TIME"],
    "z": ["REDSHIFT"],
}

FITS_KWARG_ALIASES = {
    "units": ["UNIT", "BUNIT", "BUNITS", "OUTTYPE"],
    "nu": ["NU", "FREQ", "RESTFRQ", "RESTFREQ"],
    "z": ["REDSHIFT"],
}

FITS_DEFAULT_UNITS = {"stokes": "", "nu": "Hz", "v": "m/s", "z": "", "t": "s", "eta": "deg", "xi": "deg"}

FITS_FRAMES = {
    "ra/dec": {
        "xi": {"aliases": [r"^RA-*"], "parity": -1},
        "eta": {"aliases": [r"^DEC-*"], "parity": +1},
    },
    "galactic": {
        "xi": {"aliases": [r"^GLON-*"], "parity": -1},
        "eta": {"aliases": [r"^GLAT-*"], "parity": +1},
    },
}
