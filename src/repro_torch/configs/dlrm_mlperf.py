"""dlrm-mlperf — MLPerf DLRM benchmark config (Criteo 1TB). [arXiv:1906.00091]

Table sizes are the standard Criteo-Terabyte cardinalities used by the MLPerf
reference implementation (facebookresearch/dlrm).
"""
from repro_torch.configs.base import RecsysConfig, register

CRITEO_1TB_TABLE_SIZES = (
    39_884_406, 39_043, 17_289, 7_420, 20_263, 3, 7_120, 1_543, 63,
    38_532_951, 2_953_546, 403_346, 10, 2_208, 11_938, 155, 4, 976, 14,
    39_979_771, 25_641_295, 39_664_984, 585_935, 12_972, 108, 36,
)


@register("dlrm-mlperf")
def dlrm() -> RecsysConfig:
    return RecsysConfig(
        name="dlrm-mlperf",
        variant="dlrm",
        n_dense=13,
        embed_dim=128,
        table_sizes=CRITEO_1TB_TABLE_SIZES,
        bot_mlp=(512, 256, 128),
        top_mlp=(1024, 1024, 512, 256, 1),
    )
