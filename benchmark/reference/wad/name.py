"""WAD lump names: 8-byte, uppercase, NUL-padded identifiers.

Reference behavior: rust-doom's wad/src/name.rs (charset-validated,
uppercased, NUL-padded ids) and rust-doom's wad/src/util.rs:4-10
(`is_untextured`, `is_sky_flat`).

We represent names as plain Python ``bytes`` of length 8 (hashable, cheap);
normalization happens once at the boundary.
"""

from __future__ import annotations

_VALID = frozenset(
    b"ABCDEFGHIJKLMNOPQRSTUVWXYZ0123456789_%-[]\\"
)


class BadWadName(ValueError):
    pass


def wad_name(value: bytes | str, *, strict: bool = True) -> bytes:
    """Normalize ``value`` to a canonical 8-byte, uppercase, NUL-padded name.

    Truncates at the first NUL. With ``strict`` (default) rejects invalid
    characters and over-long names like the reference; with ``strict=False``
    it is lenient (real WADs occasionally contain garbage past a NUL).
    """
    if isinstance(value, str):
        value = value.encode("ascii", errors="replace")
    out = bytearray(8)
    n = 0
    nulled = False
    for src in value[:8]:
        if src == 0:
            nulled = True
            break
        b = src - 32 if 97 <= src <= 122 else src  # ASCII uppercase
        if b not in _VALID:
            if strict:
                raise BadWadName(f"invalid byte {src!r} in WAD name {value!r}")
            b = src
        out[n] = b
        n += 1
    if not nulled and len(value) > 8 and strict:
        raise BadWadName(f"WAD name too long: {value!r}")
    return bytes(out)


def name_push(name: bytes, new_byte: int) -> bytes:
    """Append one character to a NUL-padded name (ref wad/src/name.rs:16-39).

    Raises BadWadName if the name is full or the byte is invalid.
    """
    b = new_byte - 32 if 97 <= new_byte <= 122 else new_byte
    if b not in _VALID:
        raise BadWadName(f"invalid byte {new_byte!r}")
    idx = name.find(b"\0")
    if idx < 0:
        raise BadWadName(f"WAD name too long: {name!r}")
    return name[:idx] + bytes([b]) + name[idx + 1 :]


def pad8(raw) -> bytes:
    """NUL-pad a (possibly numpy-S8-stripped) name back to 8 bytes.

    NumPy 'S8' fields drop trailing NULs on extraction; every name read out
    of a structured array must round-trip through this before comparison."""
    return bytes(raw).ljust(8, b"\0")[:8]


def is_untextured(name: bytes) -> bool:
    """A '-' name means "no texture" (ref wad/src/util.rs:4-6)."""
    return len(name) >= 2 and name[0:1] == b"-" and name[1] == 0


def is_sky_flat(name: bytes) -> bool:
    """F_SKY1 marks sky ceilings/floors (ref wad/src/util.rs:8-10)."""
    return name == b"F_SKY1\0\0"
