"""The worker->server communication path: gradient codecs and error
feedback (port of ``repro/comm``).

  compressors     -- identity, signSGD (and its majority vote), top-k and
                     CountSketch on the (W, N) gradient buffer, per leaf,
                     each with its exact bit count
  error_feedback  -- the per-worker EF memory, one (W, N) buffer (or a
                     rank's (W, width) coordinate shard) updated in place

``repro_torch.dist.aggregation.compressed_aggregate`` routes a codec
around the aggregation rules; the train step and the CNN loop carry the
EF memory across steps.
"""

from repro_torch.comm.compressors import (CODECS, Codec, CommConfig,
                                          dense_bits, get_codec,
                                          majority_vote)
from repro_torch.comm.error_feedback import (ef_encode_decode, ef_round,
                                             init_ef)

__all__ = ["CODECS", "Codec", "CommConfig", "dense_bits", "get_codec",
           "majority_vote", "ef_encode_decode", "ef_round", "init_ef"]
