"""Online mapper: config, Adam, geometry, keyframes and the mapping step."""
