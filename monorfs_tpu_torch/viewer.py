"""Recording viewer of the port: replay and rendering of recording zips,
drawn on the device by the port's own rasterizer (monorfs_tpu_torch.render)
instead of matplotlib (the counterpart of monorfs_tpu/viewer.py).

Headless re-design of the reference Viewer (mono-rfs-lib/UI/Viewer.cs:58-649
and the Manipulator draw pipeline): replays a recording frame by frame,
rendering the groundtruth trajectory, the estimate, the measurement rays and
the map's 5-sigma covariance ellipses (Navigator.cs:313-390) to PNG frames,
an MJPEG AVI or one overview figure. Tags round-trip through the recording
(Program.cs:249-268). `overview_calls` is the draw list: the data and styles
that the JAX render_overview hands to ax.plot, in the same order; a batch of
frames is drawn in one pass (render.axes.render). Only `interactive` needs
matplotlib, as its window.

    python -m monorfs_tpu_torch.viewer -f run.zip [-o out.png] [--frames DIR]
        [--avi out.avi] [--tag-shots DIR] [--interactive] [--device cuda]
"""

import argparse
import os
import sys

import numpy as np

from . import resolve_device
from .io import avi
from .io.recording import Recording
from .render import axes
from .render.png import write_png

SIZE, DPI = (960, 720), 120.0  # the JAX figure: figsize (8, 6) at dpi 120
BATCH = 16  # frames drawn in one pass


def _ellipse(mean, cov, nsigma=5.0, points=32):
    """5-sigma ellipse polyline of a 2D (or top-2x2 of 3D) covariance
    (Navigator.cs:313-390)."""
    c = np.asarray(cov)[:2, :2]
    w, v = np.linalg.eigh(c)
    w = np.maximum(w, 0)
    t = np.linspace(0, 2 * np.pi, points)
    circle = np.stack([np.cos(t), np.sin(t)])
    pts = v @ (np.sqrt(w)[:, None] * circle) * nsigma
    return mean[0] + pts[0], mean[1] + pts[1]


def overview_calls(rec: Recording, frame=None, show_measurements=True):
    """(draw list, frame index) of one overview figure: groundtruth and
    estimate trajectories, landmarks, map ellipses and the frame's
    measurements, as monorfs_tpu.viewer.render_overview plots them."""
    calls = []
    truth = np.array([s[:2] for _, s in rec.trajectory])
    calls.append(axes.Call("plot", (truth[:, 0], truth[:, 1]), "k-", dict(lw=1.2, label="groundtruth")))
    if rec.estimate:
        est = np.array([traj[-1][1][:2] for _, traj in rec.estimate if traj])
        calls.append(axes.Call("plot", (est[:, 0], est[:, 1]), "b-", dict(lw=1.0, label="estimate")))
    if rec.world.landmarks.size:
        lm = rec.world.landmarks
        calls.append(axes.Call("plot", (lm[:, 0], lm[:, 1]), "k*", dict(ms=8, label="landmarks")))
    fi = len(rec.maps) - 1 if frame is None else frame
    if rec.maps and 0 <= fi < len(rec.maps):
        for w, mean, cov in rec.maps[fi][1]:
            if w < 0.5:
                continue
            ex, ey = _ellipse(mean, cov)
            calls.append(axes.Call("plot", (ex, ey), "g-", dict(lw=0.7, alpha=0.8)))
            calls.append(axes.Call("plot", (mean[0], mean[1]), "g+", dict(ms=6)))
    if show_measurements and rec.measurements and 0 <= fi < len(rec.measurements):
        _, zs = rec.measurements[fi]
        pose = truth[min(fi, len(truth) - 1)]
        for z in zs:
            if len(z) >= 2:
                calls.append(axes.Call("plot", ([pose[0], pose[0] + z[0]], [pose[1], pose[1] + z[1]]),
                                       "r-", dict(lw=0.4, alpha=0.5)))
    return calls, fi


def overview_figure(rec: Recording, frame=None, show_measurements=True):
    calls, fi = overview_calls(rec, frame, show_measurements)
    return axes.Figure(calls, title=f"frame {fi}", size=SIZE, dpi=DPI, equal=True, legend="best")


def render_images(figures, device):
    """uint8 [H, W, 3] tensors of the figures, drawn BATCH at a time."""
    out = []
    for i in range(0, len(figures), BATCH):
        out.extend(axes.render(figures[i:i + BATCH], device).unbind(0))
    return out


def render_overview(rec: Recording, output, frame=None, show_measurements=True, device="cuda"):
    """Render one overview figure to `output` (png path or file-like)."""
    dev = resolve_device(device)
    write_png(output, render_images([overview_figure(rec, frame, show_measurements)], dev)[0])
    return output


def render_frames(rec: Recording, outdir, stride=10, device="cuda"):
    """Screenshot mode: every `stride`-th frame to outdir/frame_%05d.png
    (Viewer.cs screenshot-tag batch mode, :214-)."""
    dev = resolve_device(device)
    os.makedirs(outdir, exist_ok=True)
    idx = list(range(0, len(rec.maps), stride))
    outputs = [f"{outdir}/frame_{i:05d}.png" for i in idx]
    images = render_images([overview_figure(rec, i) for i in idx], dev)
    for out, img in zip(outputs, images):
        write_png(out, img)
    return outputs


def add_tag(rec: Recording, time, message):
    """Insert a tag (Viewer tag editing)."""
    rec.tags.append((float(time), message))
    rec.tags.sort(key=lambda x: x[0])


def _frame_image(rec: Recording, frame, device="cuda"):
    """One overview frame as a uint8 [H, W, 3] tensor on the device: the
    canvas is the frame."""
    return render_images([overview_figure(rec, frame)], resolve_device(device))[0]


def export_avi(rec: Recording, output, stride=5, fps=10, device="cuda"):
    """Render the replay to an MJPEG AVI (the video the reference Viewer
    plays interactively; Util.SaveAsAvi, Util.cs:340-378)."""
    dev = resolve_device(device)
    figures = [overview_figure(rec, i) for i in range(0, len(rec.maps), stride)]
    if not figures:
        raise ValueError("recording has no map frames to render")
    frames = [img.cpu().numpy() for img in render_images(figures, dev)]
    avi.write_mjpeg(output, frames, fps=fps)
    return output


def export_sidebar(rec: Recording, output):
    """Extract the embedded sensor-view video (sidebar.avi) to a file."""
    if not rec.sidebar:
        raise ValueError("recording has no sidebar video")
    with open(output, "wb") as f:
        f.write(rec.sidebar)
    return output


def tag_frame(rec: Recording, t):
    """The map frame a tag at time t shows (the first at or after t)."""
    times = [tm for tm, _ in rec.maps]
    fi = int(np.searchsorted(times, t)) if times else 0
    return min(fi, max(len(times) - 1, 0))


class Scrubber:
    """The timeline slider's frame index under the keys of the viewer's
    window (viewer.py:196-203 of the JAX package): right / left step, space
    jumps to the end; no matplotlib here."""

    def __init__(self, n):
        self.n = max(int(n), 1)
        self.frame = self.n - 1

    def key(self, key):
        if key == "right":
            self.frame = min(self.frame + 1, self.n - 1)
        elif key == "left":
            self.frame = max(self.frame - 1, 0)
        elif key == " ":
            self.frame = self.n - 1
        return self.frame


def interactive(rec: Recording, device="cuda"):
    """Timeline-scrub viewer (the reference Viewer's interactive mode,
    Viewer.cs:58-649): a matplotlib window that shows the port's own frame,
    with a frame slider; left/right arrows step, space jumps to the end.
    Requires matplotlib and a display."""
    dev = resolve_device(device)
    try:
        import matplotlib
    except ImportError as e:
        raise ImportError("the viewer's window needs matplotlib, which is not installed") from e
    try:
        matplotlib.use("TkAgg")
    except ImportError:
        pass
    import matplotlib.pyplot as plt
    from matplotlib.widgets import Slider

    scrub = Scrubber(len(rec.maps))
    n = scrub.n
    fig = plt.figure(figsize=(9, 7))
    ax = fig.add_axes([0.02, 0.12, 0.96, 0.86])
    ax.set_axis_off()
    sax = fig.add_axes([0.08, 0.04, 0.8, 0.04])
    slider = Slider(sax, "frame", 0, n - 1, valinit=n - 1, valstep=1)
    image = ax.imshow(_frame_image(rec, n - 1, dev).cpu().numpy())

    def draw(val):
        scrub.frame = int(val)
        image.set_data(_frame_image(rec, scrub.frame, dev).cpu().numpy())
        fig.canvas.draw_idle()

    slider.on_changed(draw)
    fig.canvas.mpl_connect("key_press_event", lambda event: slider.set_val(scrub.key(event.key)))
    plt.show()
    return scrub


def main(argv=None):
    ap = argparse.ArgumentParser(prog="monorfs-tpu-torch-viewer")
    ap.add_argument("-f", "--file", required=True, help="recording zip")
    ap.add_argument("-o", "--output", default=None, help="output png")
    ap.add_argument("--frames", default=None, help="render frame dir")
    ap.add_argument("--stride", type=int, default=10)
    ap.add_argument("--frame", type=int, default=None)
    ap.add_argument("--tag", default=None, help="'time:message' tag to add")
    ap.add_argument("--avi", default=None, help="export replay to MJPEG AVI")
    ap.add_argument("--sidebar", default=None, help="extract embedded sensor video (sidebar.avi)")
    ap.add_argument("--interactive", action="store_true", help="timeline-scrub window (requires a display)")
    ap.add_argument("--fps", type=int, default=10)
    ap.add_argument("--three-d", dest="three_d", action="store_true", default=None,
                    help="force the 3D scene renderer (viewer3d); default: auto for 3D worlds")
    ap.add_argument("--flat", dest="three_d", action="store_false", help="force the 2D top-down renderer")
    ap.add_argument("--tag-shots", default=None,
                    help="screenshot-tag batch mode: render one frame per tag into this directory (Viewer.cs:214)")
    ap.add_argument("--device", default="cuda", help="device that draws (default cuda; cpu runs the same code)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    rec = Recording.load(args.file)
    is3d = args.three_d
    if is3d is None:
        is3d = bool(rec.trajectory) and len(rec.trajectory[0][1]) >= 7
    if is3d:
        from . import viewer3d

        if args.tag_shots:
            outs = viewer3d.render_tagged_3d(rec, args.tag_shots, device=dev)
            print(f"{len(outs)} tag screenshots in {args.tag_shots}")
            return 0
        if args.interactive:
            viewer3d.interactive_3d(rec, device=dev)
            return 0
        if args.frames:
            outs = viewer3d.render_frames_3d(rec, args.frames, args.stride, device=dev)
            print(f"{len(outs)} 3D frames rendered to {args.frames}")
            return 0
        if not (args.tag or args.sidebar or args.avi):
            out = args.output or (args.file + ".3d.png")
            viewer3d.render_3d(rec, out, frame=args.frame, device=dev)
            print(f"3D overview rendered to {out}")
            return 0
    if args.tag_shots:
        os.makedirs(args.tag_shots, exist_ok=True)
        outs = [f"{args.tag_shots}/tag_{t:08.3f}.png" for t, _ in rec.tags]
        images = render_images([overview_figure(rec, tag_frame(rec, t)) for t, _ in rec.tags], dev)
        for out, img in zip(outs, images):
            write_png(out, img)
        print(f"{len(outs)} tag screenshots in {args.tag_shots}")
        return 0
    if args.tag:
        t, msg = args.tag.split(":", 1)
        add_tag(rec, float(t), msg)
        rec.save(args.file)
        print(f"tag added at {t}: {msg}")
    if args.sidebar:
        export_sidebar(rec, args.sidebar)
        print(f"sidebar video written to {args.sidebar}")
        return 0
    if args.avi:
        export_avi(rec, args.avi, stride=args.stride, fps=args.fps, device=dev)
        print(f"replay video written to {args.avi}")
        return 0
    if args.interactive:
        interactive(rec, device=dev)
        return 0
    if args.frames:
        outs = render_frames(rec, args.frames, args.stride, device=dev)
        print(f"{len(outs)} frames rendered to {args.frames}")
    else:
        out = args.output or (args.file + ".png")
        render_overview(rec, out, frame=args.frame, device=dev)
        print(f"overview rendered to {out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
