# detcheck tier manifest (docs/ANALYSIS.md):
# parameter layouts and seeded initialisation; not merge math
DETCHECK_TIER = "environment"
