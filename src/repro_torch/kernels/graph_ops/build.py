"""The build module of the port's kernels, ``repro_torch.kernels.build``,
re-exported under its earlier name for scripts that import it from here
(``tools/time_main_path.py`` loads another tree's package this way)."""

from ..build import BUILD_DIR, build_all, check, load, nvcc_path  # noqa: F401
