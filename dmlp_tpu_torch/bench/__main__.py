from dmlp_tpu_torch.bench.harness import main

if __name__ == "__main__":
    import sys
    sys.exit(main())
