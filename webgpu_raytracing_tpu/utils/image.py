"""Image I/O: a numpy + zlib PNG codec, JPEG via Pillow (cubemap faces
only, imported lazily), plus minimal Radiance-HDR and OpenEXR decoders
(the reference uses ``parse-exr`` / ``parse-hdr`` npm packages,
scene.ts:336-346)."""

from __future__ import annotations

import struct
import zlib

import numpy as np

_PNG_SIG = b"\x89PNG\r\n\x1a\n"


def _to_u8(img: np.ndarray) -> np.ndarray:
    if img.dtype != np.uint8:
        img = (np.clip(img, 0.0, 1.0) * 255.0 + 0.5).astype(np.uint8)
    return np.ascontiguousarray(img)


def encode_png(img: np.ndarray, level: int = 6) -> bytes:
    """(H, W, 3|4) float in [0, 1] or uint8 → 8-bit RGB/RGBA PNG bytes
    (filter type 0 on every row; zlib ``level`` trades size for time)."""
    arr = _to_u8(img)
    if arr.ndim != 3 or arr.shape[2] not in (3, 4):
        raise ValueError(f"expected (H, W, 3|4), got {arr.shape}")
    h, w, c = arr.shape
    rows = np.concatenate(
        [np.zeros((h, 1), np.uint8), arr.reshape(h, w * c)], axis=1
    )

    def chunk(kind: bytes, body: bytes) -> bytes:
        return (
            struct.pack(">I", len(body))
            + kind
            + body
            + struct.pack(">I", zlib.crc32(kind + body) & 0xFFFFFFFF)
        )

    ihdr = struct.pack(">IIBBBBB", w, h, 8, 2 if c == 3 else 6, 0, 0, 0)
    return (
        _PNG_SIG
        + chunk(b"IHDR", ihdr)
        + chunk(b"IDAT", zlib.compress(rows.tobytes(), level))
        + chunk(b"IEND", b"")
    )


def write_png(path: str, img: np.ndarray) -> None:
    """img: (H, W, 3) float in [0, 1] or uint8."""
    with open(path, "wb") as fh:
        fh.write(encode_png(img))


def _unfilter(raw: np.ndarray, h: int, stride: int, bpp: int) -> np.ndarray:
    """Undo the per-row PNG filters (types 0-4, PNG spec §9)."""
    out = np.zeros((h, stride), np.uint8)
    prev = np.zeros(stride, np.int32)
    for y in range(h):
        ftype = raw[y * (stride + 1)]
        line = raw[y * (stride + 1) + 1 : (y + 1) * (stride + 1)].astype(
            np.int32
        )
        if ftype == 0:
            cur = line
        elif ftype == 2:
            cur = (line + prev) & 0xFF
        elif ftype in (1, 3, 4):
            cur = np.zeros(stride, np.int32)
            for x in range(stride):
                a = cur[x - bpp] if x >= bpp else 0
                b = prev[x]
                if ftype == 1:
                    pred = a
                elif ftype == 3:
                    pred = (a + b) >> 1
                else:
                    c = prev[x - bpp] if x >= bpp else 0
                    pa, pb, pc = abs(b - c), abs(a - c), abs(a + b - 2 * c)
                    pred = a if pa <= pb and pa <= pc else (b if pb <= pc else c)
                cur[x] = (line[x] + pred) & 0xFF
        else:
            raise ValueError(f"bad PNG filter type {ftype}")
        out[y] = cur
        prev = cur
    return out


def decode_png(data: bytes) -> np.ndarray:
    """8-bit non-interlaced gray/RGB/RGBA PNG bytes → (H, W, C) uint8."""
    if not data.startswith(_PNG_SIG):
        raise ValueError("not a PNG file")
    pos, idat, hdr = 8, [], None
    while pos < len(data):
        (n,) = struct.unpack_from(">I", data, pos)
        kind = data[pos + 4 : pos + 8]
        body = data[pos + 8 : pos + 8 + n]
        pos += 12 + n
        if kind == b"IHDR":
            hdr = struct.unpack(">IIBBBBB", body)
        elif kind == b"IDAT":
            idat.append(body)
        elif kind == b"IEND":
            break
    w, h, depth, ctype, _, _, interlace = hdr
    channels = {0: 1, 2: 3, 4: 2, 6: 4}.get(ctype)
    if depth != 8 or channels is None or interlace:
        raise ValueError(
            f"unsupported PNG (depth {depth}, color {ctype}, "
            f"interlace {interlace})"
        )
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    px = _unfilter(raw, h, w * channels, channels)
    return px.reshape(h, w, channels)


def read_image(path: str) -> np.ndarray:
    """Decode PNG (numpy) or JPEG (Pillow) to (H, W, 3) float32 in
    [0, 1]."""
    with open(path, "rb") as fh:
        data = fh.read()
    if data.startswith(_PNG_SIG):
        px = decode_png(data)
        if px.shape[2] < 3:  # gray / gray+alpha
            px = np.repeat(px[..., :1], 3, axis=2)
        return px[..., :3].astype(np.float32) / 255.0
    from PIL import Image

    with Image.open(path) as im:
        return np.asarray(im.convert("RGB"), dtype=np.float32) / 255.0


def load_cubemap(paths) -> np.ndarray:
    """Six face images (+x, -x, +y, -y, +z, -z) → (6, S, S, 3) float32
    linear. JPEG/PNG inputs are sRGB-encoded; converted to linear here
    since the path tracer works in linear radiometric units."""
    faces = []
    size = None
    for p in paths:
        img = read_image(p)
        if size is None:
            size = min(img.shape[0], img.shape[1])
        if img.shape[0] != size or img.shape[1] != size:
            from PIL import Image

            with Image.open(p) as im:
                im = im.convert("RGB").resize((size, size))
                img = np.asarray(im, dtype=np.float32) / 255.0
        faces.append(srgb_to_linear_np(img))
    return np.stack(faces, axis=0)


def srgb_to_linear_np(x: np.ndarray) -> np.ndarray:
    return np.where(
        x < 0.04045, x / 12.92, ((x + 0.055) / 1.055) ** 2.4
    ).astype(np.float32)


def read_hdr(path: str) -> np.ndarray:
    """Minimal Radiance .hdr (RGBE) decoder → (H, W, 3) float32."""
    with open(path, "rb") as fh:
        data = fh.read()
    if not data.startswith(b"#?"):
        raise ValueError("not a Radiance HDR file")
    pos = data.find(b"\n\n")
    if pos < 0:
        raise ValueError("bad HDR header")
    header_end = pos + 2
    dims_end = data.find(b"\n", header_end)
    dims = data[header_end:dims_end].decode().split()
    if dims[0] != "-Y" or dims[2] != "+X":
        raise ValueError(f"unsupported HDR orientation {dims}")
    h, w = int(dims[1]), int(dims[3])
    raw = data[dims_end + 1 :]

    out = np.zeros((h, w, 4), dtype=np.uint8)
    off = 0
    for y in range(h):
        if raw[off : off + 2] == b"\x02\x02" and (raw[off + 2] << 8 | raw[off + 3]) == w:
            off += 4
            row = np.zeros((4, w), dtype=np.uint8)
            for c in range(4):
                x = 0
                while x < w:
                    count = raw[off]
                    off += 1
                    if count > 128:  # run
                        row[c, x : x + count - 128] = raw[off]
                        off += 1
                        x += count - 128
                    else:  # literal
                        row[c, x : x + count] = np.frombuffer(
                            raw, np.uint8, count, off
                        )
                        off += count
                        x += count
            out[y] = row.T
        else:  # flat RGBE row
            out[y] = np.frombuffer(raw, np.uint8, w * 4, off).reshape(w, 4)
            off += w * 4

    rgbe = out.astype(np.float32)
    e = rgbe[..., 3]
    scale = np.where(e > 0, np.ldexp(1.0, e.astype(np.int32) - 136), 0.0)
    return (rgbe[..., :3] * scale[..., None]).astype(np.float32)


def read_exr(path: str) -> np.ndarray:
    """Minimal OpenEXR scanline decoder (float32/half, NONE or ZIP/ZIPS
    compression) → (H, W, 3) float32. Covers the reference's 4k equirect
    asset class (scene.ts:336-341)."""
    with open(path, "rb") as fh:
        data = fh.read()
    if data[:4] != b"\x76\x2f\x31\x01":
        raise ValueError("not an EXR file")
    pos = 8

    def read_cstr():
        nonlocal pos
        end = data.index(b"\x00", pos)
        s = data[pos:end].decode()
        pos = end + 1
        return s

    attrs = {}
    while True:
        name = read_cstr()
        if not name:
            break
        atype = read_cstr()
        (size,) = struct.unpack_from("<i", data, pos)
        pos += 4
        attrs[name] = (atype, data[pos : pos + size])
        pos += size

    # channels
    craw = attrs["channels"][1]
    cpos = 0
    channels = []
    while craw[cpos] != 0:
        cend = craw.index(b"\x00", cpos)
        cname = craw[cpos:cend].decode()
        (ptype,) = struct.unpack_from("<i", craw, cend + 1)
        channels.append((cname, ptype))  # 0=uint, 1=half, 2=float
        cpos = cend + 1 + 16
    channels_sorted = channels  # EXR stores channels alphabetically

    (xmin, ymin, xmax, ymax) = struct.unpack("<4i", attrs["dataWindow"][1])
    w = xmax - xmin + 1
    h = ymax - ymin + 1
    comp = attrs["compression"][1][0]  # 0=NONE, 2=ZIPS, 3=ZIP
    if comp not in (0, 2, 3):
        raise ValueError(f"unsupported EXR compression {comp}")
    lines_per_block = 1 if comp in (0, 2) else 16

    n_blocks = (h + lines_per_block - 1) // lines_per_block
    offsets = struct.unpack_from(f"<{n_blocks}q", data, pos)

    dtypes = {1: np.float16, 2: np.float32}
    sizes = {1: 2, 2: 4}
    out = {c: np.zeros((h, w), np.float32) for c, _ in channels_sorted}

    for off in offsets:
        (y0,) = struct.unpack_from("<i", data, off)
        (nbytes,) = struct.unpack_from("<i", data, off + 4)
        block = data[off + 8 : off + 8 + nbytes]
        if comp in (2, 3):
            raw2 = zlib.decompress(block)
            # EXR zip: un-delta (cumulative — each byte adds enc[i]-128 to
            # the RECONSTRUCTED previous byte) then un-interleave
            enc = np.frombuffer(raw2, np.uint8).astype(np.int64)
            enc[1:] -= 128
            arr = (np.cumsum(enc) % 256).astype(np.uint8)
            half = (len(arr) + 1) // 2
            out_b = np.zeros_like(arr)
            out_b[0::2] = arr[:half]
            out_b[1::2] = arr[half : half + len(arr) // 2]
            block = out_b.tobytes()
        ny = min(lines_per_block, ymax - y0 + 1)
        bpos = 0
        for yy in range(y0, y0 + ny):
            for cname, ptype in channels_sorted:
                n = w * sizes[ptype]
                row = np.frombuffer(block, dtypes[ptype], w, bpos)
                out[cname][yy - ymin] = row.astype(np.float32)
                bpos += n

    chans = [c for c, _ in channels_sorted]
    if all(c in out for c in ("R", "G", "B")):
        return np.stack([out["R"], out["G"], out["B"]], axis=-1)
    first = out[chans[0]]
    return np.stack([first] * 3, axis=-1)


def rmse(a: np.ndarray, b: np.ndarray) -> float:
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    return float(np.sqrt(np.mean((a - b) ** 2)))
