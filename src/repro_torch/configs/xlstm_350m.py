"""xlstm-350m [ssm] — alternating mLSTM + sLSTM blocks.

24L d_model=1024 4H (kv=4) d_ff=0 vocab=50304.
Source: xLSTM [arXiv:2405.04517] (the 350M xLSTM[1:1] configuration).
d_ff=0: blocks carry their own internal projections (mLSTM proj-factor 2
up/down; sLSTM post-FFN factor 4/3).  Recurrent state is O(1) per token ->
runs long_500k.
"""

from ..models.api import ModelConfig

CONFIG = ModelConfig(
    name="xlstm-350m",
    arch_type="ssm",
    num_layers=24,
    d_model=1024,
    num_heads=4,
    num_kv_heads=4,
    d_ff=0,
    vocab_size=50304,
    ffn_kind="none",
    mixer_pattern=("mlstm", "slstm"),
    supports_long_context=True,
)
