"""RGB-D dataset conversion and loading: the port's own copy of
monorfs_tpu.frontend.dataset (NumPy only).

Replaces the reference's .oni pipeline at the data level: video2oni
(reference: video2oni/video2oni.cpp:335-480) converted TUM-style PNG streams
(depth.txt / rgb.txt timestamp-path indexes) into OpenNI .oni recordings;
here the same TUM input converts into a single .npz with dense arrays."""

import os

import numpy as np


def _read_index(path):
    out = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            parts = line.split()
            out.append((float(parts[0]), parts[1]))
    return out


def _load_png(path):
    """PNG loader: the native librfsio decoder when it builds and loads
    (monorfs_tpu_torch/native.py), else the pure-Python fallback below."""
    with open(path, "rb") as f:
        data = f.read()
    from ..native import decode_png

    native = decode_png(data)
    if native is not None:
        return native
    return _load_png_py(data)


def _load_png_py(data):
    """Minimal pure-Python PNG decoder (grayscale/RGB/16-bit)."""
    import struct
    import zlib
    assert data[:8] == b"\x89PNG\r\n\x1a\n", "not a png"
    pos = 8
    idat = b""
    meta = {}
    while pos < len(data):
        length = struct.unpack(">I", data[pos : pos + 4])[0]
        ctype = data[pos + 4 : pos + 8]
        chunk = data[pos + 8 : pos + 8 + length]
        if ctype == b"IHDR":
            (meta["w"], meta["h"], meta["depth"], meta["color"], _, _,
             meta["interlace"]) = struct.unpack(">IIBBBBB", chunk)
        elif ctype == b"IDAT":
            idat += chunk
        elif ctype == b"IEND":
            break
        pos += 12 + length
    raw = zlib.decompress(idat)
    channels = {0: 1, 2: 3, 4: 2, 6: 4}[meta["color"]]
    bpp = meta["depth"] // 8 * channels
    w, h = meta["w"], meta["h"]
    stride = w * bpp
    img = np.zeros((h, stride), np.uint8)
    prev = np.zeros(stride, np.int32)
    pos = 0
    for row in range(h):
        ft = raw[pos]
        line = np.frombuffer(raw[pos + 1 : pos + 1 + stride], np.uint8).astype(
            np.int32
        )
        pos += 1 + stride
        if ft == 0:
            cur = line
        elif ft == 1:  # sub
            cur = line.copy()
            for i in range(bpp, stride):
                cur[i] = (cur[i] + cur[i - bpp]) & 0xFF
        elif ft == 2:  # up
            cur = (line + prev) & 0xFF
        elif ft == 3:  # average
            cur = line.copy()
            for i in range(stride):
                left = cur[i - bpp] if i >= bpp else 0
                cur[i] = (cur[i] + ((left + prev[i]) >> 1)) & 0xFF
        elif ft == 4:  # paeth
            cur = line.copy()
            for i in range(stride):
                a = cur[i - bpp] if i >= bpp else 0
                b = prev[i]
                c = prev[i - bpp] if i >= bpp else 0
                p = a + b - c
                pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
                pred = a if (pa <= pb and pa <= pc) else (b if pb <= pc else c)
                cur[i] = (cur[i] + pred) & 0xFF
        else:
            raise ValueError(f"bad filter {ft}")
        img[row] = cur.astype(np.uint8)
        prev = cur
    if meta["depth"] == 16:
        arr = img.reshape(h, w, channels, 2)
        out = (arr[..., 0].astype(np.uint16) << 8) | arr[..., 1]
        return out.squeeze()
    return img.reshape(h, w, channels).squeeze()


def convert_tum(directory, output, depth_scale=5000.0, max_frames=None):
    """Convert a TUM RGB-D directory (depth.txt + rgb.txt) into an npz with
    time [T], depth [T, H, W] float32 meters, gray [T, H, W] uint8."""
    depth_index = _read_index(os.path.join(directory, "depth.txt"))
    rgb_index = _read_index(os.path.join(directory, "rgb.txt"))
    if max_frames:
        depth_index = depth_index[:max_frames]

    times, depths, grays = [], [], []
    for t, dpath in depth_index:
        # associate nearest rgb frame
        rt, rpath = min(rgb_index, key=lambda x: abs(x[0] - t))
        d = _load_png(os.path.join(directory, dpath)).astype(np.float32)
        d /= depth_scale
        rgb = _load_png(os.path.join(directory, rpath))
        gray = (
            rgb.mean(axis=-1).astype(np.uint8)
            if rgb.ndim == 3
            else rgb.astype(np.uint8)
        )
        times.append(t)
        depths.append(d)
        grays.append(gray)
    np.savez_compressed(
        output,
        time=np.asarray(times),
        depth=np.stack(depths),
        gray=np.stack(grays),
    )
    return output


def synthesize_rgbd(output, frames=60, h=240, w=320, seed=0,
                    flat_depth=None, pan_rate=0.3):
    """Synthetic RGB-D sequence for kinect-pipeline experiments/tests
    (stands in for the reference's room.oni recording, chap3/K6): a textured
    wall of random bright squares at 1.2-1.8 m with the camera panning
    across it, depth following the square boundaries. Deterministic.

    With `flat_depth` set, every pixel sits at that constant depth, which
    makes the image pan geometrically EXACT for a laterally translating
    pinhole camera: shifting the window by `off` pixels equals a camera
    translation of off * flat_depth / f. Returns (path, offsets) so tests
    can reconstruct the true trajectory."""
    rng = np.random.default_rng(seed)
    big_w = w * 2
    gray_wall = np.full((h, big_w), 40, np.uint8)
    depth_wall = np.full((h, big_w), 1.8, np.float32)
    for _ in range(90):
        y = rng.integers(10, h - 26)
        x = rng.integers(10, big_w - 26)
        s = rng.integers(8, 22)
        shade = rng.integers(120, 255)
        gray_wall[y : y + s, x : x + s] = shade
        depth_wall[y : y + s, x : x + s] = rng.uniform(1.2, 1.6)
    if flat_depth is not None:
        depth_wall[:] = flat_depth

    times, depths, grays, offsets = [], [], [], []
    for i in range(frames):
        off = int(round(i * (big_w - w) / max(frames - 1, 1) * pan_rate)) % (
            big_w - w
        )
        times.append(i / 30.0)
        offsets.append(off)
        grays.append(gray_wall[:, off : off + w].copy())
        depths.append(depth_wall[:, off : off + w].copy())
    np.savez_compressed(
        output,
        time=np.asarray(times),
        depth=np.stack(depths),
        gray=np.stack(grays),
    )
    return output, np.asarray(offsets)


def synthesize_rgbd_parallax(output, frames=40, h=120, w=160, focal=200.0,
                             seed=0, travel=0.25, n_patches=70):
    """True 3D perspective render with parallax: bright frontoparallel
    square patches at varied depths in front of a far wall, camera
    translating laterally along +x. Unlike the texture-scroll wall
    (synthesize_rgbd), nearby patches shift more pixels per frame than
    distant ones -- the depth structure is real, so a SLAM run against this
    stream exercises genuine 3D geometry and has an ANALYTIC ground-truth
    trajectory. Returns (path, true_x [T]) with true_x the camera
    x-position per frame (y = z = 0, identity orientation, looking +z)."""
    rng = np.random.default_rng(seed)
    cx, cy = w / 2.0, h / 2.0
    z_bg = 3.0
    # patch centers spread to cover the swept frustum
    span_x = (w / 2.0) / focal * z_bg + travel
    span_y = (h / 2.0) / focal * z_bg
    px = rng.uniform(-span_x, span_x + travel, n_patches)
    py = rng.uniform(-span_y * 0.9, span_y * 0.9, n_patches)
    pz = rng.uniform(1.2, 2.4, n_patches)
    ps = rng.uniform(0.06, 0.16, n_patches)  # world-unit square size
    shade = rng.integers(110, 255, n_patches)
    order = np.argsort(-pz)  # painter's algorithm: far to near

    times, depths, grays, xs = [], [], [], []
    for i in range(frames):
        x_t = travel * i / max(frames - 1, 1)
        gray = np.full((h, w), 40, np.uint8)
        depth = np.full((h, w), z_bg, np.float32)
        for j in order:
            half = ps[j] / 2.0
            u0 = focal * (px[j] - half - x_t) / pz[j] + cx
            u1 = focal * (px[j] + half - x_t) / pz[j] + cx
            v0 = focal * (py[j] - half) / pz[j] + cy
            v1 = focal * (py[j] + half) / pz[j] + cy
            iu0, iu1 = max(int(np.ceil(u0)), 0), min(int(np.floor(u1)) + 1, w)
            iv0, iv1 = max(int(np.ceil(v0)), 0), min(int(np.floor(v1)) + 1, h)
            if iu0 >= iu1 or iv0 >= iv1:
                continue
            gray[iv0:iv1, iu0:iu1] = shade[j]
            depth[iv0:iv1, iu0:iu1] = pz[j]
        times.append(i / 30.0)
        depths.append(depth)
        grays.append(gray)
        xs.append(x_t)
    np.savez_compressed(
        output,
        time=np.asarray(times),
        depth=np.stack(depths),
        gray=np.stack(grays),
    )
    return output, np.asarray(xs)


class RGBDDataset:
    """Loader for converted npz RGB-D streams."""

    def __init__(self, path):
        data = np.load(path)
        self.time = data["time"]
        self.depth = data["depth"]
        self.gray = data["gray"]

    def __len__(self):
        return len(self.time)

    def frame(self, i):
        return self.time[i], self.depth[i], self.gray[i]
