"""Engine protocols, one module per configuration's `task` name."""
