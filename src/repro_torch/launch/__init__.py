
# detcheck tier manifest (docs/ANALYSIS.md):
# CLI timing/printing; not on the resolve path
DETCHECK_TIER = "environment"
