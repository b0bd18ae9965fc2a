"""The training-data cache (``datacache.DeviceDataCache``)."""
from flink_ml_tpu_torch.iteration.datacache import DeviceDataCache

__all__ = ["DeviceDataCache"]
