"""The kernels' plain versions (every wrapper runs its plain version)."""
