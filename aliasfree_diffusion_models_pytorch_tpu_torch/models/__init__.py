"""UNet variants 0-4 and their blocks."""
