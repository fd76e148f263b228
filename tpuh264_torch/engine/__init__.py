"""Engine layer of the port: config, rate control, metrics, sources, the
GOP device pipelines (`tpuh264_torch.engine.devpipe`), the live App
(`.app`), and the session path: EncoderSession, DecoderSession /
DecoderPool and the fan-out Pipeline."""

from .config import CodecConfig
from .decoder import DecoderPool, DecoderSession
from .encoder import EncodedFrame, EncoderSession
from .pipeline import Pipeline

__all__ = ["CodecConfig", "DecoderPool", "DecoderSession", "EncodedFrame",
           "EncoderSession", "Pipeline"]
