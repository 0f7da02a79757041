"""Host-side motion math for BVH export (numpy)."""
