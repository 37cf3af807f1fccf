"""Plain references, one module per configuration's `reference` name.

Each imports torch and numpy alone: nothing of the program under test
and nothing of the JAX package."""
