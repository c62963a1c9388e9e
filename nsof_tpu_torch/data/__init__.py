"""Host-side data layer of the port: the bundled reference scenes and the
weightless segmenter."""
