"""The serving daemon of the port and its client (counterpart of ``s2v_tpu/serving``)."""

from s2v_torch.serving.client import request
from s2v_torch.serving.daemon import ServingDaemon

__all__ = ["ServingDaemon", "request"]
