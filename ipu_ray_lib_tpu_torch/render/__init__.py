"""Full-frame renderers built on the megakernel."""
