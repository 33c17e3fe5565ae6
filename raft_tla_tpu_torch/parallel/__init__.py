"""The mesh: exhaustive checking and simulation over n shards."""
