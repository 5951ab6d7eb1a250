"""xlstm-350m [ssm]: 24L d_model=1024 4H d_ff=0 vocab=50304.

sLSTM + mLSTM blocks (Beck et al., arXiv:2405.04517), xLSTM[7:1] ratio:
each 8-layer unit is 7 mLSTM + 1 sLSTM.  d_ff=0: xLSTM blocks carry their
own projections (mLSTM pf=2, sLSTM pf=4/3), no separate FFN.
Recurrent state -> sub-quadratic -> runs long_500k.
"""
from repro_torch.models.config import LayerKind, ModelConfig

UNIT = (LayerKind.MLSTM,) * 7 + (LayerKind.SLSTM,)

CONFIG = ModelConfig(
    name="xlstm-350m",
    family="ssm",
    num_layers=24,
    d_model=1024,
    num_heads=4,
    num_kv_heads=4,
    d_ff=0,
    vocab_size=50304,
    pattern_unit=UNIT,
    sub_quadratic=True,
)

REDUCED = ModelConfig(
    name="xlstm-350m-reduced",
    family="ssm",
    num_layers=8,
    d_model=64,
    num_heads=4,
    num_kv_heads=4,
    d_ff=0,
    vocab_size=512,
    pattern_unit=UNIT,
    sub_quadratic=True,
    q_chunk=16,
    kv_chunk=16,
)
