"""Runtime support: straggler detection."""
