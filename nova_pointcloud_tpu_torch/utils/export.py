"""Export helpers: images, videos, point clouds (the port's own copy of
``nova_pointcloud_tpu/utils/export.py``: an image through PIL, a video to
mp4 through imageio, with an animated GIF beside the path where no mp4
writer works, and an ASCII PLY writer for point clouds, byte for byte the
JAX function's text). PIL and imageio are imported inside the functions
that use them: the card's installation has neither.
"""

import os
from typing import Optional, Sequence

import numpy as np


def export_to_image(image, path: str, quality: int = 95) -> str:
    """Save a uint8 (H, W, C) array or a PIL image."""
    from PIL import Image

    if not hasattr(image, "save"):
        image = Image.fromarray(np.asarray(image))
    image.save(path, quality=quality)
    return path


def export_to_video(frames: Sequence[np.ndarray], path: str, fps: int = 12) -> str:
    """Write frames (T, H, W, 3 uint8) to mp4; where that fails (no mp4
    writer), an animated GIF beside ``path``. Returns the file written."""
    try:
        import imageio.v2 as imageio

        writer = imageio.get_writer(path, fps=fps)
        for f in frames:
            writer.append_data(np.asarray(f))
        writer.close()
        return path
    except Exception:
        from PIL import Image

        base, _ = os.path.splitext(path)
        gif = base + ".gif"
        imgs = [Image.fromarray(np.asarray(f)[..., :3]) for f in frames]
        imgs[0].save(gif, save_all=True, append_images=imgs[1:],
                     duration=max(int(1000 / fps), 1), loop=0)
        return gif


def export_to_ply(points: np.ndarray, path: str, colors: Optional[np.ndarray] = None) -> str:
    """ASCII PLY of (N, 3) points, with optional (N, 3) colors in [0, 1]."""
    points = np.asarray(points, np.float32)
    with open(path, "w") as f:
        f.write("ply\nformat ascii 1.0\n")
        f.write(f"element vertex {len(points)}\n")
        f.write("property float x\nproperty float y\nproperty float z\n")
        if colors is not None:
            f.write("property uchar red\nproperty uchar green\nproperty uchar blue\n")
        f.write("end_header\n")
        if colors is not None:
            rgb = (np.asarray(colors) * 255).clip(0, 255).astype(np.uint8)
            for p, c in zip(points, rgb):
                f.write(f"{p[0]:.6f} {p[1]:.6f} {p[2]:.6f} {c[0]} {c[1]} {c[2]}\n")
        else:
            for p in points:
                f.write(f"{p[0]:.6f} {p[1]:.6f} {p[2]:.6f}\n")
    return path
