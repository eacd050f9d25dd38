"""Tools that read limits and run controls on the card."""
