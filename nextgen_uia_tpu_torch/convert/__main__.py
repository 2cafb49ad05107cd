from .torch_to_npz import main

if __name__ == "__main__":
    main()
