"""Surface velocimetry from a real river video.

Mirrors the reference tutorial ``02_Process_velocimetry.ipynb``: open the
Geul river clip with its camera configuration, preprocess frames
(temporal-mean normalization), orthorectify to the measurement grid, run
FFT cross-correlation PIV, and write the velocity Dataset to netCDF.

The frames->ortho->PIV chain runs as jitted XLA programs on the default
JAX device (a GPU, or the CPU with the same semantics), so the example runs
anywhere.

Run:  python examples/02_process_velocimetry.py [output_dir] [n_frames]
"""

import os
import sys

REF = "/root/reference/examples/geul"


def main(out_dir: str, n_frames: int = 24) -> None:
    import numpy as np

    import pyorc_tpu

    os.makedirs(out_dir, exist_ok=True)
    video = pyorc_tpu.Video(
        os.path.join(REF, "dk_control.mp4"),
        camera_config=os.path.join(REF, "dk_cam_config.json"),
        start_frame=0,
        end_frame=n_frames,
        h_a=92.36,  # actual water level during the recording [m ref datum]
    )
    da = video.get_frames()
    print(f"frames: {dict(da.sizes)}")

    da_norm = da.frames.normalize()
    da_proj = da_norm.frames.project()
    print(f"projected grid: {dict(da_proj.sizes)} at {video.camera_config.resolution} m/px")

    piv = da_proj.frames.get_piv()
    piv.velocimetry.set_encoding()
    out_nc = os.path.join(out_dir, "geul_piv.nc")
    piv.to_netcdf(out_nc)

    speed = np.hypot(piv["v_x"].values, piv["v_y"].values)
    print(f"wrote {out_nc}")
    print(f"  median surface speed: {np.nanmedian(speed):.3f} m/s")
    print(f"  valid vectors: {100 * np.isfinite(speed).mean():.1f}%")


if __name__ == "__main__":
    main(
        sys.argv[1] if len(sys.argv) > 1 else "/tmp/pyorc_tpu_example02",
        int(sys.argv[2]) if len(sys.argv) > 2 else 24,
    )
