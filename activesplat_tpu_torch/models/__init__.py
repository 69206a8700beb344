"""The Gaussian map and its cameras."""
