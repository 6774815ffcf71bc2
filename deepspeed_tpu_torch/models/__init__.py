"""Model definitions: ``TransformerConfig``, parameter layout, presets."""
