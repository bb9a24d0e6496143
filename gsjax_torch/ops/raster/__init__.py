from gsjax_torch.ops.raster.camera import Camera  # noqa: F401
from gsjax_torch.ops.raster.config import RasterConfig  # noqa: F401
from gsjax_torch.ops.raster.api import mark_visible, render  # noqa: F401
