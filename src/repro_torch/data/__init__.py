from repro_torch.data.synthetic import batch_shapes, SyntheticTask

# detcheck tier manifest (docs/ANALYSIS.md):
# synthetic data generation, seeded per task
DETCHECK_TIER = "environment"
