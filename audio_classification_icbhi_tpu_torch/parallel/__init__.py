"""The train and eval steps, and the data-parallel mesh they shard over."""
