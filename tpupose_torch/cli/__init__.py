"""Command-line entry points: evalmodel, testmodel, score."""
