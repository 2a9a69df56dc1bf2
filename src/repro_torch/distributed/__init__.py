from repro_torch.distributed.sharding import (
    MODEL_AXIS, DATA_AXIS, POD_AXIS, PROD_AXIS_SIZES, RULES, PartitionSpec,
    batch_axes, batch_spec, filter_spec, maybe_constrain, pspec,
    specs_from_defs, stack_specs,
)
