"""Default experiment schema and typed-config builders."""
