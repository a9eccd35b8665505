"""xlstm-1.3b [ssm] — sLSTM + mLSTM blocks [arXiv:2405.04517].

48L d_model=2048 4H (GQA kv=4) d_ff=0 vocab=50304.  d_ff=0: xLSTM blocks
carry their own up/down projections (mLSTM pf=2, sLSTM pf=4/3), so there is
no separate FFN.  Period = 7 mLSTM : 1 sLSTM (the paper's xLSTM[7:1]), the
sLSTM placed at position 3 within the period as in the released models.
Long-context: O(1) recurrent state => runs long_500k natively.
Copy of ``repro/configs/xlstm_1_3b.py``.
"""

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="xlstm-1.3b",
    arch_type="ssm",
    num_layers=48,
    d_model=2048,
    num_heads=4,
    num_kv_heads=4,
    d_ff=0,
    vocab_size=50304,
    block_pattern=("mlstm", "mlstm", "mlstm", "slstm",
                   "mlstm", "mlstm", "mlstm", "mlstm"),
    pos="none",
    norm="rmsnorm",
    tie_embeddings=False,
    mlstm_proj_factor=2.0,
    slstm_proj_factor=4.0 / 3.0,
)
