"""Printers of standalone programs for a stencil (torch_source)."""
