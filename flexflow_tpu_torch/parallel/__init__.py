"""Device-free parallel layout: mesh axes and placement specs."""
