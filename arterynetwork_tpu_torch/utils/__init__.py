"""Transfer helpers and synthetic phantoms."""
