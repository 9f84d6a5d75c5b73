"""Dense (K4) and CSR (K5) matrix-vector products of the spmv route."""
